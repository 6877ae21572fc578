from .common import Embedding, Linear
from .norm import RMSNorm

__all__ = ["Embedding", "Linear", "RMSNorm"]
