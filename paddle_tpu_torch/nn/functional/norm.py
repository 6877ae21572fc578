"""Normalisation functionals
(counterpart of paddle_tpu/nn/functional/norm.py)."""
from __future__ import annotations

import torch


def rms_norm(x, weight=None, epsilon=1e-6):
    """RMSNorm with float32 statistics for any input dtype; the result is
    cast back to ``x``'s dtype before the weight multiplies it, as in the
    reference."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    out = (xf * torch.reciprocal(torch.sqrt(ms + epsilon))).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out
