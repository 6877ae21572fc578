"""Activation functionals
(counterpart of paddle_tpu/nn/functional/activation.py).

Every activation the reference's ``nn.functional`` has, under its name and
with its parameters in its order, because layers reach them by name
(``TransformerEncoderLayer`` calls ``getattr(F, activation)``). Each is
the reference's formula in plain PyTorch elementwise ops, in the input's
dtype; the reference has no Pallas kernel for any of them (XLA fuses
them into their neighbours).

Where the reference's formula differs from PyTorch's function of the same
name, the reference's is kept: ``hardsigmoid``'s slope is 0.1666667, not
1/6, and ``rrelu`` always takes the mean slope ``(lower + upper) / 2``,
in training too (the reference ignores ``training``). ``gumbel_softmax``
draws its noise from ``generator`` (a ``torch.Generator`` on ``x``'s
device; PyTorch's default when None), so its draws differ from the
reference's JAX stream.

``relu_``, ``elu_``, ``tanh_`` and ``softmax_`` write the result into
their input and return it, as the reference's in-place spellings do.
"""
from __future__ import annotations

import torch

from ...core.dispatch import primitive
from ...framework import random as _random

_tf = torch.nn.functional

_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
           "float32": torch.float32, "float64": torch.float64}


def _cast(x, dtype):
    if dtype is None:
        return x
    return x.to(_DTYPES[dtype] if isinstance(dtype, str) else dtype)


@primitive
def relu(x):
    return torch.relu(x)


@primitive
def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


@primitive
def gelu(x, approximate=False):
    """GELU; the exact erf form by default, the tanh form with
    ``approximate=True`` (the reference's ``jax.nn.gelu`` flag)."""
    return _tf.gelu(x, approximate="tanh" if approximate else "none")


@primitive
def sigmoid(x):
    return torch.sigmoid(x)


@primitive
def tanh(x):
    return torch.tanh(x)


@primitive
def silu(x):
    return _tf.silu(x)


def swish(x):
    return silu(x)


@primitive
def mish(x):
    return x * torch.tanh(_tf.softplus(x))


@primitive
def elu(x, alpha=1.0):
    return _tf.elu(x, alpha=alpha)


@primitive
def selu(x, scale=1.0507009873554804934193349852946,
         alpha=1.6732632423543772848170429916717):
    return scale * _tf.elu(x, alpha=alpha)


@primitive
def celu(x, alpha=1.0):
    return _tf.celu(x, alpha=alpha)


@primitive
def leaky_relu(x, negative_slope=0.01):
    return torch.where(x >= 0, x, negative_slope * x)


@primitive
def prelu(x, weight, data_format="NCHW"):
    """``where(x > 0, x, w * x)``; a weight of more than one element runs
    along the channel axis (1 for ``NC*`` formats, else the last)."""
    w = weight
    if w.numel() > 1 and x.dim() > 1:
        shape = [1] * x.dim()
        ch_axis = 1 if data_format.startswith("NC") else x.dim() - 1
        shape[ch_axis] = w.numel()
        w = w.reshape(shape)
    return torch.where(x > 0, x, w * x)


@primitive
def rrelu(x, lower=0.125, upper=0.3333333333333333, training=False):
    slope = (lower + upper) / 2.0
    return torch.where(x >= 0, x, slope * x)


@primitive
def hardtanh(x, min=-1.0, max=1.0):
    return torch.clamp(x, min, max)


@primitive
def hardsigmoid(x, slope=0.1666667, offset=0.5):
    return torch.clamp(x * slope + offset, 0.0, 1.0)


@primitive
def hardswish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


@primitive
def hardshrink(x, threshold=0.5):
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


@primitive
def softshrink(x, threshold=0.5):
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


@primitive
def tanhshrink(x):
    return x - torch.tanh(x)


@primitive
def softplus(x, beta=1.0, threshold=20.0):
    """``x`` where ``x * beta > threshold``, else
    ``log(1 + exp(x * beta)) / beta``."""
    xb = x * beta
    soft = torch.logaddexp(xb, torch.zeros_like(xb)) / beta
    return torch.where(xb > threshold, x, soft)


@primitive
def softsign(x):
    return x / (1 + x.abs())


@primitive
def softmax(x, axis=-1, dtype=None):
    return torch.softmax(_cast(x, dtype), dim=int(axis))


@primitive
def log_softmax(x, axis=-1, dtype=None):
    return torch.log_softmax(_cast(x, dtype), dim=int(axis))


@primitive
def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, generator=None):
    """``softmax((x + g) / temperature)`` with Gumbel noise ``g``; with
    ``hard``, the one-hot of its argmax in the forward and the soft
    values' gradient (the straight-through estimator)."""
    u = torch.rand(x.shape, generator=_random.generator_or(
        generator, x.device), device=x.device, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    g = (-torch.log(-torch.log(u.clamp(min=tiny)))).to(x.dtype)
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = y.argmax(dim=axis, keepdim=True)
        one_hot = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = one_hot + y - y.detach()
    return y


@primitive
def maxout(x, groups, axis=1):
    axis = axis % x.dim()
    shape = list(x.shape)
    shape[axis] = shape[axis] // groups
    shape.insert(axis + 1, groups)
    return x.reshape(shape).amax(dim=axis + 1)


@primitive
def glu(x, axis=-1):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


@primitive
def thresholded_relu(x, threshold=1.0):
    return torch.where(x > threshold, x, torch.zeros_like(x))


@primitive
def log_sigmoid(x, name=None):
    return _tf.logsigmoid(x)


def _inplace(fn):
    def op(x, *args, **kwargs):
        return x.copy_(fn(x, *args, **kwargs))

    op.__name__ = fn.__name__ + "_"
    op.__doc__ = "In-place spelling of %s: writes into x, returns x." % (
        fn.__name__)
    return op


relu_ = _inplace(relu)
elu_ = _inplace(elu)
tanh_ = _inplace(tanh)
softmax_ = _inplace(softmax)
