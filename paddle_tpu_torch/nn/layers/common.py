"""The common layers (counterpart of paddle_tpu/nn/layers/common.py):
``Linear``, ``Embedding``, the dropouts, the shape layers (``Flatten``,
``Unflatten``, ``Identity``), resizing, padding, the pixel and channel
rearrangements, ``Bilinear``, ``CosineSimilarity``, ``Fold`` and
``Unfold``, each over its functional with the reference's defaults
(``UpsamplingBilinear2D`` aligns corners, as there).

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
``Bilinear`` (``weight [out, in1, in2]``, ``bias [out]``) takes the
reference's ``weight_attr`` / ``bias_attr`` through
``initializer.create_parameter``: the global initializer or XavierNormal
for the weight, zeros for the bias.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...core.tensor import Parameter
from ...device import resolve_device
from ...kernels.quant import int8_weight_matmul, routed_int8_weight
from .. import functional as F
from ..functional import dropout
from ..initializer import create_parameter


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
        if qw is None:
            return F.linear(x, self.weight, self.bias)
        out = int8_weight_matmul(x, *qw)
        return out if self.bias is None else out + self.bias

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


class Dropout2D(nn.Module):
    """``F.dropout2d``: whole channels dropped, from ``generator``."""

    def __init__(self, p=0.5, data_format="NCHW", name=None, *,
                 generator=None):
        super().__init__()
        self.p = p
        self.data_format = data_format
        self.generator = generator

    def forward(self, x):
        return F.dropout2d(x, p=self.p, training=self.training,
                           data_format=self.data_format,
                           generator=self.generator)


class Dropout3D(Dropout2D):
    def __init__(self, p=0.5, data_format="NCDHW", name=None, *,
                 generator=None):
        super().__init__(p, data_format, name, generator=generator)

    def forward(self, x):
        return F.dropout3d(x, p=self.p, training=self.training,
                           data_format=self.data_format,
                           generator=self.generator)


class AlphaDropout(nn.Module):
    def __init__(self, p=0.5, name=None, *, generator=None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        return F.alpha_dropout(x, p=self.p, training=self.training,
                               generator=self.generator)


class Flatten(nn.Module):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)


class Unflatten(nn.Module):
    """``axis`` of ``x`` split into ``shape``."""

    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis = axis
        self.shape = list(shape)

    def forward(self, x):
        s = list(x.shape)
        ax = self.axis % len(s)
        return x.reshape(s[:ax] + self.shape + s[ax + 1:])


class Identity(nn.Module):
    def forward(self, x):
        return x


class Upsample(nn.Module):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, data_format="NCHW", name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, size=self.size, scale_factor=self.scale_factor,
                             mode=self.mode, align_corners=self.align_corners,
                             data_format=self.data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, data_format)


class Pad1D(nn.Module):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None):
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, mode=self.mode, value=self.value,
                     data_format=self.data_format)


class Pad2D(Pad1D):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad3D(Pad1D):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(Pad1D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class PixelShuffle(nn.Module):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(nn.Module):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class ChannelShuffle(nn.Module):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups = groups
        self.data_format = data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class Bilinear(nn.Module):
    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.weight = create_parameter(
            [out_features, in1_features, in2_features], weight_attr, **kw)
        self.bias = create_parameter([out_features], bias_attr,
                                     is_bias=True, **kw)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class CosineSimilarity(nn.Module):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class Unfold(nn.Module):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.kernel_sizes = kernel_sizes
        self.strides = strides
        self.paddings = paddings
        self.dilations = dilations

    def forward(self, x):
        return F.unfold(x, self.kernel_sizes, self.strides, self.paddings,
                        self.dilations)


class Fold(Unfold):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__(kernel_sizes, strides, paddings, dilations)
        self.output_sizes = output_sizes

    def forward(self, x):
        return F.fold(x, self.output_sizes, self.kernel_sizes, self.strides,
                      self.paddings, self.dilations)
