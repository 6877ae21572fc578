"""Elementwise and general math (counterpart of paddle_tpu/ops/math.py).

Every function the reference registers as a primitive is one here, under
the same name (``core.dispatch``). Bodies are torch operations on the
inputs' device; type promotion is torch's, which agrees with ``jnp``'s for
these families (the tests check each). Integer inputs of the
transcendental functions give the default float dtype, as in ``jnp``.

Arguments the reference accepts and never applies raise
``NotImplementedError`` for any value but the default ("Faults of the
reference" 22 in ROADMAP.md): ``scale``'s ``act`` and the ``dtype`` of
``cumsum`` and ``cumprod``.
"""
from __future__ import annotations

import torch

from ..core import dtype as _dtype
from ..core.dispatch import primitive


def _tensor(x, like=None):
    """``x`` as a tensor on ``like``'s device; a number becomes a 0-d
    tensor, which torch promotes as ``jnp`` promotes a weak scalar."""
    if isinstance(x, torch.Tensor):
        return x
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(x, device=dev)


def _floating(x):
    """``x`` in the default float dtype when it is not floating or
    complex (``jnp``'s rule for transcendental functions)."""
    if x.is_floating_point() or x.is_complex():
        return x
    return x.to(_dtype.to_torch(None))


def _ignored(fn, name, value, default):
    if value != default:
        raise NotImplementedError(
            "%s(%s=%r): the reference accepts it and never applies it "
            "(\"Faults of the reference\" 22 in ROADMAP.md)"
            % (fn, name, value))


def _binop(name, fn):
    def op(x, y):
        return fn(_tensor(x, y), _tensor(y, x))

    op.__name__ = op.__qualname__ = name
    return primitive(op, name=name)


def _same_dtype(fn):
    """A torch binary function that wants both operands of one dtype,
    given them promoted."""
    def run(x, y):
        x, y = _tensor(x, y), _tensor(y, x)
        dt = torch.result_type(x, y)
        if not (dt.is_floating_point or dt.is_complex):
            dt = _dtype.to_torch(None)
        return fn(x.to(dt), y.to(dt))
    return run


add = _binop("add", torch.add)
subtract = _binop("subtract", torch.sub)
multiply = _binop("multiply", torch.mul)
divide = _binop("divide", torch.true_divide)
floor_divide = _binop("floor_divide", torch.floor_divide)
remainder = _binop("remainder", torch.remainder)
mod = remainder
floor_mod = remainder
maximum = _binop("maximum", torch.maximum)
minimum = _binop("minimum", torch.minimum)
fmax = _binop("fmax", torch.fmax)
fmin = _binop("fmin", torch.fmin)
pow_ = _binop("pow", torch.pow)
atan2 = _binop("atan2", _same_dtype(torch.atan2))
heaviside = _binop("heaviside", lambda x, y: torch.heaviside(
    *_promoted(x, y)))
nextafter = _binop("nextafter", _same_dtype(torch.nextafter))
hypot = _binop("hypot", _same_dtype(torch.hypot))
copysign = _binop("copysign", _same_dtype(torch.copysign))
gcd = _binop("gcd", lambda x, y: torch.gcd(*_promoted(x, y)))
lcm = _binop("lcm", lambda x, y: torch.lcm(*_promoted(x, y)))
logaddexp = _binop("logaddexp", _same_dtype(torch.logaddexp))


def _promoted(x, y):
    x, y = _tensor(x, y), _tensor(y, x)
    dt = torch.result_type(x, y)
    return x.to(dt), y.to(dt)


def pow(x, y):  # noqa: A001
    return pow_(x, y)


def _unop(name, fn, floating=True):
    def op(x):
        x = _tensor(x)
        return fn(_floating(x) if floating else x)

    op.__name__ = op.__qualname__ = name
    return primitive(op, name=name)


def _imag(x):
    return x.imag if x.is_complex() else torch.zeros_like(x)


abs = _unop("abs", torch.abs, floating=False)  # noqa: A001
neg = _unop("neg", torch.neg, floating=False)
exp = _unop("exp", torch.exp)
expm1 = _unop("expm1", torch.expm1)
log = _unop("log", torch.log)
log2 = _unop("log2", torch.log2)
log10 = _unop("log10", torch.log10)
log1p = _unop("log1p", torch.log1p)
sqrt = _unop("sqrt", torch.sqrt)
rsqrt = _unop("rsqrt", torch.rsqrt)
square = _unop("square", torch.square, floating=False)
sin = _unop("sin", torch.sin)
cos = _unop("cos", torch.cos)
tan = _unop("tan", torch.tan)
asin = _unop("asin", torch.asin)
acos = _unop("acos", torch.acos)
atan = _unop("atan", torch.atan)
sinh = _unop("sinh", torch.sinh)
cosh = _unop("cosh", torch.cosh)
tanh = _unop("tanh", torch.tanh)
asinh = _unop("asinh", torch.asinh)
acosh = _unop("acosh", torch.acosh)
atanh = _unop("atanh", torch.atanh)
floor = _unop("floor", torch.floor, floating=False)
ceil = _unop("ceil", torch.ceil, floating=False)
round_ = _unop("round", torch.round, floating=False)
trunc = _unop("trunc", torch.trunc, floating=False)
frac = _unop("frac", lambda x: x - torch.trunc(x), floating=False)
sign = _unop("sign", torch.sign, floating=False)
reciprocal = _unop("reciprocal", torch.reciprocal)
erf = _unop("erf", torch.erf)
erfinv = _unop("erfinv", torch.erfinv)
lgamma = _unop("lgamma", torch.lgamma)
digamma = _unop("digamma", torch.digamma)
i0 = _unop("i0", torch.special.i0)
sigmoid = _unop("sigmoid", torch.sigmoid)
rad2deg = _unop("rad2deg", torch.rad2deg)
deg2rad = _unop("deg2rad", torch.deg2rad)
angle = _unop("angle", torch.angle)
conj = _unop("conj", lambda x: torch.conj(x).resolve_conj(),
             floating=False)
real = _unop("real", lambda x: x.real if x.is_complex() else x,
             floating=False)
imag = _unop("imag", _imag, floating=False)


def round(x):  # noqa: A001
    return round_(x)


@primitive
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None):
    _ignored("scale", "act", act, None)
    x = _tensor(x)
    return x * scale + bias if bias_after_scale else (x + bias) * scale


@primitive
def clip(x, min=None, max=None):
    x = _tensor(x)
    if min is None and max is None:
        return x
    return torch.clamp(x, min, max)


@primitive
def lerp(x, y, weight):
    x = _tensor(x)
    return x + _tensor(weight, x) * (_tensor(y, x) - x)


@primitive
def stanh(x, scale_a=0.67, scale_b=1.7159):
    return scale_b * torch.tanh(scale_a * _floating(_tensor(x)))


@primitive
def logit(x, eps=None):
    x = _floating(_tensor(x))
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


@primitive
def multiply_add(x, y, z):
    x = _tensor(x)
    return x * _tensor(y, x) + _tensor(z, x)


@primitive
def addmm(input, x, y, beta=1.0, alpha=1.0):
    return beta * _tensor(input) + alpha * torch.matmul(_tensor(x),
                                                       _tensor(y))


@primitive
def matmul(x, y, transpose_x=False, transpose_y=False):
    x, y = _tensor(x), _tensor(y)
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


@primitive
def dot(x, y):
    return torch.sum(_tensor(x) * _tensor(y), dim=-1)


@primitive
def mm(x, y):
    return torch.matmul(_tensor(x), _tensor(y))


@primitive
def bmm(x, y):
    return torch.matmul(_tensor(x), _tensor(y))


@primitive
def mv(x, vec):
    return torch.matmul(_tensor(x), _tensor(vec))


@primitive
def inner(x, y):
    return torch.inner(*_promoted(x, y))


@primitive
def outer(x, y):
    x, y = _promoted(x, y)
    return torch.outer(x.reshape(-1), y.reshape(-1))


@primitive
def kron(x, y):
    return torch.kron(*_promoted(x, y))


@primitive
def cross(x, y, axis=9):
    x, y = _promoted(x, y)
    ax = axis if axis != 9 else next(
        (i for i, s in enumerate(x.shape) if s == 3), -1)
    return torch.linalg.cross(x, y, dim=ax)


@primitive
def trace(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(_tensor(x), offset, axis1, axis2).sum(-1)


@primitive
def diagonal(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(_tensor(x), offset, axis1, axis2)


def _cum_dtype(x):
    """``jnp``'s accumulator: an integer input keeps its dtype, bool
    counts in the default integer."""
    if x.dtype == torch.bool:
        return torch.int64
    return x.dtype


@primitive
def cumsum(x, axis=None, dtype=None):
    _ignored("cumsum", "dtype", dtype, None)
    x = _tensor(x)
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.cumsum(x, dim=axis, dtype=_cum_dtype(x))


@primitive
def cumprod(x, dim=None, dtype=None):
    _ignored("cumprod", "dtype", dtype, None)
    x = _tensor(x)
    if dim is None:
        x, dim = x.reshape(-1), 0
    return torch.cumprod(x, dim=dim, dtype=_cum_dtype(x))


@primitive
def cummax_values(x, axis=-1):
    return torch.cummax(_tensor(x), dim=axis).values


@primitive
def cummin_values(x, axis=-1):
    return torch.cummin(_tensor(x), dim=axis).values


@primitive
def nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(_tensor(x), nan=nan, posinf=posinf,
                            neginf=neginf)


@primitive(nondiff=True)
def isnan(x):
    return torch.isnan(_tensor(x))


@primitive(nondiff=True)
def isinf(x):
    return torch.isinf(_tensor(x))


@primitive(nondiff=True)
def isfinite(x):
    return torch.isfinite(_tensor(x))


@primitive
def increment(x, value=1.0):
    return _tensor(x) + value


@primitive
def cast(x, dtype):
    return _tensor(x).to(_dtype.to_torch(dtype))


def astype(x, dtype):
    return cast(x, dtype=dtype)


@primitive
def logcumsumexp(x, axis=-1):
    """The running log-sum-exp along ``axis``; float16 runs in float32."""
    x = _floating(_tensor(x))
    xf = x.float() if x.dtype == torch.float16 else x
    return torch.logcumsumexp(xf, dim=axis).to(x.dtype)


@primitive
def dist(x, y, p=2.0):
    x, y = _promoted(x, y)
    d = torch.abs(x - y).float()
    if p == float("inf"):
        return torch.amax(d).to(x.dtype)
    if p == 0:
        return torch.sum((d != 0).float()).to(x.dtype)
    return (torch.sum(d ** p) ** (1.0 / p)).to(x.dtype)


@primitive
def renorm(x, p, axis, max_norm):
    x = _tensor(x)
    moved = torch.movedim(x, axis, 0)
    flat = moved.reshape(moved.shape[0], -1).float()
    norms = torch.sum(torch.abs(flat) ** p, dim=1) ** (1.0 / p)
    factor = torch.where(norms > max_norm,
                         max_norm / torch.clamp(norms, min=1e-12),
                         torch.ones_like(norms))
    out = flat * factor[:, None]
    return torch.movedim(out.reshape(moved.shape), 0, axis).to(x.dtype)


@primitive(nondiff=True)
def mode(x, axis=-1, keepdim=False):
    """The most frequent value along ``axis`` (the largest among equally
    frequent ones) and the last index where it occurs."""
    x = _tensor(x)
    xs = torch.movedim(x, axis, -1)
    n = xs.shape[-1]
    counts = (xs[..., :, None] == xs[..., None, :]).sum(-1)
    top = counts.amax(-1, keepdim=True)
    low = torch.finfo(xs.dtype).min if xs.is_floating_point() else \
        torch.iinfo(xs.dtype).min
    values = torch.where(counts == top, xs, torch.full_like(xs, low)
                         ).amax(-1)
    pos = torch.arange(n, device=x.device).expand_as(xs)
    indices = torch.where(xs == values[..., None], pos,
                          torch.full_like(pos, -1)).amax(-1)
    if keepdim:
        values = values.unsqueeze(axis)
        indices = indices.unsqueeze(axis)
    return values, indices.to(torch.int64)


@primitive
def nanmedian(x, axis=None, keepdim=False):
    """The median of the non-NaN values (the mean of the two middle ones
    for an even count), NaN where all are NaN."""
    x = _tensor(x)
    xf = _floating(x)
    if axis is None:
        src, dim = xf.reshape(-1), 0
    else:
        src, dim = xf, axis
    out = torch.nanquantile(src.float(), 0.5, dim=dim,
                            keepdim=keepdim and axis is not None)
    if axis is None and keepdim:
        out = out.reshape((1,) * x.dim())
    return out.to(xf.dtype)


@primitive
def squared_l2_norm(x):
    xf = _tensor(x).float()
    return torch.sum(xf * xf)


@primitive
def clip_by_norm(x, max_norm):
    x = _tensor(x)
    norm = torch.sqrt(torch.sum(x.float() ** 2))
    factor = torch.where(norm > max_norm,
                         max_norm / torch.clamp(norm, min=1e-12),
                         torch.ones_like(norm))
    return (x * factor).to(x.dtype)


@primitive
def add_n(inputs):
    if not isinstance(inputs, (list, tuple)):
        return _tensor(inputs)
    out = _tensor(inputs[0])
    for t in inputs[1:]:
        out = out + t
    return out


@primitive
def identity_loss(x, reduction="none"):
    x = _tensor(x)
    if reduction in ("mean", 0):
        return torch.mean(x)
    if reduction in ("sum", 1):
        return torch.sum(x)
    return x

