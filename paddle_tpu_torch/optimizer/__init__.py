from . import lr
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .optimizer import L2Decay, Optimizer
from .optimizers import Adam, AdamW

__all__ = ["Adam", "AdamW", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "L2Decay", "Optimizer", "lr"]
