"""``framework`` (counterpart of paddle_tpu/framework): ``save`` / ``load``."""
from .io import load, save

__all__ = ["load", "save"]
