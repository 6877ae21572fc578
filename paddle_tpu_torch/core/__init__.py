from . import flags
from .flags import flag, get_flags, set_flags

__all__ = ["flag", "flags", "get_flags", "set_flags"]
