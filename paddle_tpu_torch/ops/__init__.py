"""Tensor operations (counterpart of paddle_tpu/ops/): so far the four
of ``manipulation`` that ``nn.functional`` re-exports or calls."""
from . import manipulation
from .manipulation import diag_embed, one_hot, pad, unfold

__all__ = ["manipulation", "diag_embed", "one_hot", "pad", "unfold"]
