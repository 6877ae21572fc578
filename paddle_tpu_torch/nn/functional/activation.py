"""Activation functionals
(counterpart of paddle_tpu/nn/functional/activation.py)."""
from __future__ import annotations

import torch


def silu(x):
    return torch.nn.functional.silu(x)


def gelu(x, approximate=False):
    """GELU; the exact erf form by default, the tanh form with
    ``approximate=True`` (the reference's ``jax.nn.gelu`` flag)."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")
