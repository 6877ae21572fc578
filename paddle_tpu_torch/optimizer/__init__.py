from . import lr
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .optimizer import L1Decay, L2Decay, Optimizer
from .optimizers import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb,
                         LarsMomentum, Momentum, RMSProp)

__all__ = ["SGD", "Adadelta", "Adagrad", "Adam", "AdamW", "Adamax",
           "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "L1Decay", "L2Decay", "Lamb", "LarsMomentum", "Momentum",
           "Optimizer", "RMSProp", "lr"]
