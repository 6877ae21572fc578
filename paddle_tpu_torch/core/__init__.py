from . import flags
from .flags import flag, get_flags, set_flags
from .tensor import Parameter, name_parameters

__all__ = ["Parameter", "flag", "flags", "get_flags", "name_parameters",
           "set_flags"]
