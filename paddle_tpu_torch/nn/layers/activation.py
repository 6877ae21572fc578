"""Activation layers (counterpart of paddle_tpu/nn/layers/activation.py).

Each layer calls its functional in ``nn/functional/activation.py`` with
the reference's constructor arguments; ``name`` is accepted and unused, as
there. ``PReLU`` owns a ``weight [num_parameters]`` filled with ``init``
on ``device`` (the card unless ``device="cpu"``). ``RReLU`` takes the mean
slope in training too, as the reference's functional does.
"""
from __future__ import annotations

import torch
from torch import nn

from ...core.tensor import Parameter
from ...device import resolve_device
from .. import functional as F


def _simple(cls_name, fn_name):
    """A layer class without arguments that applies ``F.<fn_name>``."""

    def __init__(self, name=None):
        nn.Module.__init__(self)

    def forward(self, x):
        return getattr(F, fn_name)(x)

    return type(cls_name, (nn.Module,), {
        "__init__": __init__, "forward": forward, "__module__": __name__,
        "__doc__": "``F.%s``." % fn_name})


ReLU = _simple("ReLU", "relu")
ReLU6 = _simple("ReLU6", "relu6")
Sigmoid = _simple("Sigmoid", "sigmoid")
Tanh = _simple("Tanh", "tanh")
Silu = _simple("Silu", "silu")
Mish = _simple("Mish", "mish")
Hardsigmoid = _simple("Hardsigmoid", "hardsigmoid")
Hardswish = _simple("Hardswish", "hardswish")
Tanhshrink = _simple("Tanhshrink", "tanhshrink")
Softsign = _simple("Softsign", "softsign")
LogSigmoid = _simple("LogSigmoid", "log_sigmoid")


class Swish(Silu):
    pass


class GELU(nn.Module):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, approximate=self.approximate)


class ELU(nn.Module):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.elu(x, alpha=self.alpha)


class SELU(nn.Module):
    def __init__(self, scale=1.0507009873554805, alpha=1.6732632423543772,
                 name=None):
        super().__init__()
        self.scale = scale
        self.alpha = alpha

    def forward(self, x):
        return F.selu(x, scale=self.scale, alpha=self.alpha)


class CELU(nn.Module):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.celu(x, alpha=self.alpha)


class LeakyReLU(nn.Module):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, negative_slope=self.negative_slope)


class PReLU(nn.Module):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.data_format = data_format
        self.weight = Parameter(torch.full(
            (num_parameters,), init, dtype=dtype,
            device=resolve_device(device)))

    def forward(self, x):
        return F.prelu(x, self.weight, data_format=self.data_format)


class Hardtanh(nn.Module):
    def __init__(self, min=-1.0, max=1.0, name=None):
        super().__init__()
        self.min, self.max = min, max

    def forward(self, x):
        return F.hardtanh(x, min=self.min, max=self.max)


class Hardshrink(nn.Module):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.hardshrink(x, threshold=self.threshold)


class Softshrink(nn.Module):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.softshrink(x, threshold=self.threshold)


class Softplus(nn.Module):
    def __init__(self, beta=1.0, threshold=20.0, name=None):
        super().__init__()
        self.beta, self.threshold = beta, threshold

    def forward(self, x):
        return F.softplus(x, beta=self.beta, threshold=self.threshold)


class Softmax(nn.Module):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.softmax(x, axis=self.axis)


class LogSoftmax(nn.Module):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.log_softmax(x, axis=self.axis)


class Maxout(nn.Module):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self.groups, self.axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self.groups, self.axis)


class ThresholdedReLU(nn.Module):
    def __init__(self, threshold=1.0, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.thresholded_relu(x, threshold=self.threshold)


class RReLU(nn.Module):
    def __init__(self, lower=0.125, upper=1.0 / 3.0, name=None):
        super().__init__()
        self._lower, self._upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self._lower, self._upper, training=self.training)


class Softmax2D(nn.Module):
    """Softmax over the channel axis of NCHW inputs."""

    def forward(self, x):
        return F.softmax(x, axis=-3)
