"""Linear, Embedding and Dropout (counterpart of
paddle_tpu/nn/layers/common.py).

``Linear.weight`` keeps Paddle's ``[in_features, out_features]`` layout,
so ``y = x @ W``: the reference's weights load without a transpose, and
the product is the same orientation the reference's XLA matmul computes.
The bias follows the reference's rule: a zero-initialised ``bias
[out_features]`` unless ``bias_attr is False`` (Llama's projections pass
False; GPT's keep theirs), added after the product.

Inside ``kernels.quant.int8_weight_routes(table)`` (the serving engine's
weight-only int8 decode, ``FLAGS_serving_quant_weights``), a ``Linear``
found in ``table`` multiplies through its int8 copy with
``int8_weight_matmul`` instead of its fp32 weight, and adds its bias
after that product.

Initialisation draws from an explicit ``torch.Generator`` with the
reference's laws: XavierNormal for ``Linear`` (std
``sqrt(2 / (in + out))``), N(0, 1) for ``Embedding``. The numbers differ
from the reference's JAX streams; tests copy weights across instead.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...core.tensor import Parameter
from ...kernels.quant import int8_weight_matmul, routed_int8_weight
from ..functional import dropout


def _normal(shape, std, generator, device, dtype):
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return Parameter((w * std).to(dtype))


class Linear(nn.Module):
    def __init__(self, in_features, out_features, *, bias_attr=None,
                 generator, device, dtype=torch.float32):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = _normal((in_features, out_features),
                              math.sqrt(2.0 / (in_features + out_features)),
                              generator, device, dtype)
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = Parameter(torch.zeros(out_features, device=device,
                                              dtype=dtype))

    def forward(self, x):
        qw = routed_int8_weight(self)
        if qw is not None:
            out = int8_weight_matmul(x, *qw)
        else:
            out = torch.matmul(x, self.weight)
        if self.bias is not None:
            out = out + self.bias
        return out

    def extra_repr(self):
        return "in=%d, out=%d" % (self.in_features, self.out_features)


class Embedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, *, generator, device,
                 dtype=torch.float32):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = _normal((num_embeddings, embedding_dim), 1.0,
                              generator, device, dtype)

    def forward(self, ids):
        return torch.nn.functional.embedding(ids, self.weight)


class Dropout(nn.Module):
    """``F.dropout`` with the module's training flag; ``axis`` and
    ``name`` are the reference's arguments and unused, as there. The mask
    comes from ``generator`` (PyTorch's default generator when None)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None,
                 *, generator=None):
        super().__init__()
        self.p = p
        self.mode = mode
        self.generator = generator

    def forward(self, x):
        return dropout(x, p=self.p, training=self.training, mode=self.mode,
                       generator=self.generator)
