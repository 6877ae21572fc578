"""Weight initializers (counterpart of paddle_tpu/nn/initializer.py).

Each initializer has ``create(shape, dtype, device, generator)``, a new
``Parameter`` (``device`` defaults to the card and raises without one),
and ``__call__(param, generator=None)``, which fills an existing tensor
in place under ``no_grad``. Random ones draw in float32 from
``generator`` (a ``torch.Generator`` on the device; PyTorch's default
generator when None) and cast to the dtype; the draws differ from the
reference's JAX stream, the laws are the same. ``Constant``, ``Assign``
and ``Dirac`` are exact, ``Orthogonal``'s result is orthogonal (times
``gain``), ``TruncatedNormal`` truncates at two standard deviations, and
the fans are the reference's (``_fans``).

``create_parameter`` is the reference's ``Layer.create_parameter``
rule for the layers that take a ``ParamAttr``: the attr's
``initializer``, else the layer's default, else the global one
(``set_global_initializer``, or XavierNormal for a weight and zeros for a
bias); ``attr=False`` gives no parameter, and the attr's ``trainable``
and ``name`` are kept. The port's older layers (``Linear``, the
convolutions, the norms ...) keep their own fixed initialisation.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.tensor import Parameter
from ..device import resolve_device


def _torch_dtype(dtype):
    if dtype is None:
        return torch.float32
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


class Initializer:
    def create(self, shape, dtype=None, device=None, generator=None):
        """A new ``Parameter`` of ``shape`` on ``device``."""
        shape = tuple(int(s) for s in shape)
        return Parameter(self._generate(shape, _torch_dtype(dtype),
                                        resolve_device(device), generator))

    def __call__(self, param, generator=None):
        """Fills ``param`` in place; returns it."""
        with torch.no_grad():
            param.copy_(self._generate(tuple(param.shape), param.dtype,
                                       param.device, generator))
        return param

    def _generate(self, shape, dtype, device, generator):
        raise NotImplementedError


def _randn(shape, device, generator):
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32)


def _rand(shape, low, high, device, generator):
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return u * (high - low) + low


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _generate(self, shape, dtype, device, generator):
        return torch.full(shape, self.value, dtype=dtype, device=device)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _generate(self, shape, dtype, device, generator):
        return (_randn(shape, device, generator) * self.std
                + self.mean).to(dtype)


class TruncatedNormal(Initializer):
    """``mean + std * z``, ``z`` a standard normal truncated to [-2, 2]
    (by its inverse distribution function)."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _generate(self, shape, dtype, device, generator):
        lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
        u = _rand(shape, lo, 1 - lo, device, generator)
        z = (math.sqrt(2) * torch.erfinv(2 * u - 1)).clamp(-2.0, 2.0)
        return (z * self.std + self.mean).to(dtype)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def _generate(self, shape, dtype, device, generator):
        return _rand(shape, self.low, self.high, device, generator).to(dtype)


def _fans(shape):
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _generate(self, shape, dtype, device, generator):
        fi, fo = _fans(shape)
        std = self.gain * math.sqrt(2.0 / ((self.fan_in or fi)
                                           + (self.fan_out or fo)))
        return (_randn(shape, device, generator) * std).to(dtype)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _generate(self, shape, dtype, device, generator):
        fi, fo = _fans(shape)
        limit = self.gain * math.sqrt(6.0 / ((self.fan_in or fi)
                                             + (self.fan_out or fo)))
        return _rand(shape, -limit, limit, device, generator).to(dtype)


def _kaiming_gain(negative_slope, nonlinearity):
    if nonlinearity in ("relu", "leaky_relu"):
        return math.sqrt(2.0 / (1 + negative_slope ** 2))
    return 1.0


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _generate(self, shape, dtype, device, generator):
        fi = self.fan_in or _fans(shape)[0]
        std = _kaiming_gain(self.negative_slope,
                            self.nonlinearity) / math.sqrt(fi)
        return (_randn(shape, device, generator) * std).to(dtype)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _generate(self, shape, dtype, device, generator):
        fi = self.fan_in or _fans(shape)[0]
        limit = _kaiming_gain(self.negative_slope,
                              self.nonlinearity) * math.sqrt(3.0 / fi)
        return _rand(shape, -limit, limit, device, generator).to(dtype)


class Orthogonal(Initializer):
    """``gain`` times the Q of a Gaussian matrix's QR decomposition, its
    columns' signs fixed by R's diagonal; the trailing axis is the
    columns, the rest the rows (``jax.nn.initializers.orthogonal``)."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def _generate(self, shape, dtype, device, generator):
        n_cols = shape[-1]
        n_rows = math.prod(shape) // n_cols
        flip = n_rows < n_cols
        a = _randn((n_cols, n_rows) if flip else (n_rows, n_cols), device,
                   generator)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if flip:
            q = q.T
        return (self.gain * q.reshape(shape)).to(dtype)


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def _generate(self, shape, dtype, device, generator):
        v = self.value
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        return torch.as_tensor(np.asarray(v), device=device).to(
            dtype).reshape(shape)


class Dirac(Initializer):
    """Ones at the centre of the kernel of output channel ``i`` and input
    channel ``i % in_channels``, zeros elsewhere, as the reference
    places them (``groups`` is unused there too)."""

    def __init__(self, groups=1):
        self.groups = groups

    def _generate(self, shape, dtype, device, generator):
        out = np.zeros(shape, dtype=np.float32)
        centers = tuple(s // 2 for s in shape[2:])
        for i in range(shape[0]):
            out[(i, i % shape[1]) + centers] = 1.0
        return torch.from_numpy(out).to(device=device, dtype=dtype)


_GLOBAL_WEIGHT_INIT = None
_GLOBAL_BIAS_INIT = None


def set_global_initializer(weight_init, bias_init=None):
    global _GLOBAL_WEIGHT_INIT, _GLOBAL_BIAS_INIT
    _GLOBAL_WEIGHT_INIT = weight_init
    _GLOBAL_BIAS_INIT = bias_init


def default_weight_init():
    return _GLOBAL_WEIGHT_INIT or XavierNormal()


def default_bias_init():
    return _GLOBAL_BIAS_INIT or Constant(0.0)


def _attr_field(attr, key):
    return attr.get(key) if isinstance(attr, dict) else getattr(attr, key,
                                                                None)


def create_parameter(shape, attr=None, dtype=None, is_bias=False,
                     default_initializer=None, *, device=None,
                     generator=None):
    """A ``Parameter`` by the reference's rule (``ParamAttr`` or a dict
    as ``attr``), or None when ``attr is False``."""
    if attr is False:
        return None
    init, trainable, name = default_initializer, True, None
    if attr is not None:
        init = _attr_field(attr, "initializer") or init
        name = _attr_field(attr, "name")
        if _attr_field(attr, "trainable") is not None:
            trainable = _attr_field(attr, "trainable")
    if init is None:
        init = default_bias_init() if is_bias else default_weight_init()
    p = init.create(shape, dtype, device, generator)
    p.requires_grad_(bool(trainable))
    p.name = name
    return p
