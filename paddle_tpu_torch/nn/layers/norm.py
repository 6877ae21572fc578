"""RMSNorm and LayerNorm (counterpart of paddle_tpu/nn/layers/norm.py)."""
from __future__ import annotations

import torch
from torch import nn

from ...core.tensor import Parameter
from ..functional import layer_norm, rms_norm


class RMSNorm(nn.Module):
    def __init__(self, hidden_size, epsilon=1e-6, *, device,
                 dtype=torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.weight = Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype))

    def forward(self, x):
        return rms_norm(x, self.weight, self.epsilon)


class LayerNorm(nn.Module):
    """The reference's LayerNorm: ``weight`` ones and ``bias`` zeros of
    ``normalized_shape``, either left out when its attr is False."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device,
                 dtype=torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight = None if weight_attr is False else Parameter(
            torch.ones(self.normalized_shape, device=device, dtype=dtype))
        self.bias = None if bias_attr is False else Parameter(
            torch.zeros(self.normalized_shape, device=device, dtype=dtype))

    def forward(self, x):
        return layer_norm(x, self.normalized_shape, self.weight, self.bias,
                          epsilon=self.epsilon)
