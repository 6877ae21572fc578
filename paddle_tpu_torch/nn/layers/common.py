"""Linear and Embedding (counterpart of paddle_tpu/nn/layers/common.py).

``Linear.weight`` keeps Paddle's ``[in_features, out_features]`` layout,
so ``y = x @ W``: the reference's weights load without a transpose, and
the product is the same orientation the reference's XLA matmul computes.
The Llama path uses no bias, so this slice's ``Linear`` has none.

Inside ``kernels.quant.int8_weight_routes(table)`` (the serving engine's
weight-only int8 decode, ``FLAGS_serving_quant_weights``), a ``Linear``
found in ``table`` multiplies through its int8 copy with
``int8_weight_matmul`` instead of its fp32 weight.

Initialisation draws from an explicit ``torch.Generator`` with the
reference's laws: XavierNormal for ``Linear`` (std
``sqrt(2 / (in + out))``), N(0, 1) for ``Embedding``. The numbers differ
from the reference's JAX streams; tests copy weights across instead.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...kernels.quant import int8_weight_matmul, routed_int8_weight


def _normal(shape, std, generator, device, dtype):
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return nn.Parameter((w * std).to(dtype))


class Linear(nn.Module):
    def __init__(self, in_features, out_features, *, generator, device,
                 dtype=torch.float32):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = _normal((in_features, out_features),
                              math.sqrt(2.0 / (in_features + out_features)),
                              generator, device, dtype)

    def forward(self, x):
        qw = routed_int8_weight(self)
        if qw is not None:
            return int8_weight_matmul(x, *qw)
        return torch.matmul(x, self.weight)

    def extra_repr(self):
        return "in=%d, out=%d" % (self.in_features, self.out_features)


class Embedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, *, generator, device,
                 dtype=torch.float32):
        super().__init__()
        self.weight = _normal((num_embeddings, embedding_dim), 1.0,
                              generator, device, dtype)

    def forward(self, ids):
        return torch.nn.functional.embedding(ids, self.weight)
