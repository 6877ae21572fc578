from . import functional
from .layers import *  # noqa: F401,F403
from .layers import __all__ as _layers

__all__ = ["functional"] + list(_layers)
