"""RMSNorm (counterpart of paddle_tpu/nn/layers/norm.py)."""
from __future__ import annotations

import torch
from torch import nn

from ..functional import rms_norm


class RMSNorm(nn.Module):
    def __init__(self, hidden_size, epsilon=1e-6, *, device,
                 dtype=torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype))

    def forward(self, x):
        return rms_norm(x, self.weight, self.epsilon)
