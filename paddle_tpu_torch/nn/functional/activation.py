"""Activation functionals
(counterpart of paddle_tpu/nn/functional/activation.py)."""
from __future__ import annotations

import torch


def silu(x):
    return torch.nn.functional.silu(x)
