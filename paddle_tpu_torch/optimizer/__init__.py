from .optimizer import L2Decay, Optimizer
from .optimizers import Adam, AdamW

__all__ = ["Adam", "AdamW", "L2Decay", "Optimizer"]
