"""Convolution layers (counterpart of paddle_tpu/nn/layers/conv.py).

``weight`` is ``[out, in / groups, *k]`` (``[in, out / groups, *k]`` for
the transposed layers) and ``bias`` ``[out]``, left out when ``bias_attr
is False`` (ResNet's convolutions). They are drawn from ``generator`` (a
``torch.Generator`` on ``device``; seed 0 when omitted) with the
reference's laws: the weight from KaimingUniform on ``fan_in = in /
groups * prod(k)`` (``U(-sqrt(6 / fan_in), sqrt(6 / fan_in))``), the bias
from ``U(-1 / sqrt(fan_in), 1 / sqrt(fan_in))``. The numbers differ from
the reference's JAX streams; tests copy weights across instead.
``padding_mode`` and a ``weight_attr`` / ``bias_attr`` other than None or
False are accepted and unused (the reference's ``padding_mode`` is unused
too).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...core.tensor import Parameter
from ...device import resolve_device
from .. import functional as F


def _ntuple(v, n):
    if isinstance(v, (list, tuple)):
        return list(v) if len(v) > 1 else list(v) * n
    return [v] * n


def _uniform(shape, limit, generator, device, dtype):
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return Parameter(((u * 2 - 1) * limit).to(dtype))


class _ConvNd(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, n, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 transposed=False, output_padding=0, *, generator=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _ntuple(kernel_size, n)
        self.stride = _ntuple(stride, n)
        self.padding = padding
        self.dilation = _ntuple(dilation, n)
        self.groups = groups
        self.data_format = data_format
        self.output_padding = output_padding
        if transposed:
            w_shape = [in_channels, out_channels // groups] + self.kernel_size
        else:
            w_shape = [out_channels, in_channels // groups] + self.kernel_size
        fan_in = (in_channels // groups) * math.prod(self.kernel_size)
        self.weight = _uniform(w_shape, math.sqrt(6.0 / fan_in), generator,
                               device, dtype)
        self.bias = None if bias_attr is False else _uniform(
            [out_channels], 1.0 / math.sqrt(fan_in), generator, device,
            dtype)


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL", **kw):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, **kw)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, stride=self.stride,
                        padding=self.padding, dilation=self.dilation,
                        groups=self.groups, data_format=self.data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", **kw):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, **kw)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, stride=self.stride,
                        padding=self.padding, dilation=self.dilation,
                        groups=self.groups, data_format=self.data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 **kw):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, **kw)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, stride=self.stride,
                        padding=self.padding, dilation=self.dilation,
                        groups=self.groups, data_format=self.data_format)


class _ConvTransposeNd(_ConvNd):
    _n = None
    _fn = None

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format=None, **kw):
        super().__init__(in_channels, out_channels, kernel_size, self._n,
                         stride, padding, dilation, groups, "zeros",
                         weight_attr, bias_attr, data_format,
                         transposed=True, output_padding=output_padding, **kw)

    def forward(self, x):
        return type(self)._fn(x, self.weight, self.bias, stride=self.stride,
                              padding=self.padding,
                              output_padding=self.output_padding,
                              dilation=self.dilation, groups=self.groups,
                              data_format=self.data_format)


class Conv1DTranspose(_ConvTransposeNd):
    _n, _fn = 1, F.conv1d_transpose

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCL", **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, dilation, groups,
                         weight_attr, bias_attr, data_format, **kw)


class Conv2DTranspose(_ConvTransposeNd):
    _n, _fn = 2, F.conv2d_transpose

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW", **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, dilation, groups,
                         weight_attr, bias_attr, data_format, **kw)


class Conv3DTranspose(_ConvTransposeNd):
    _n, _fn = 3, F.conv3d_transpose

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, dilation, groups,
                         weight_attr, bias_attr, data_format, **kw)
