"""Reductions (counterpart of paddle_tpu/ops/reduction.py).

``axis`` is None (every axis), an int or a list of ints, as in the
reference. Integer sums and products accumulate in int64, as ``jnp`` does
with 64-bit types on; a mean, a standard deviation or a median of
integers is in the default float dtype. ``median`` and ``quantile``
interpolate linearly between the two nearest values, ``jnp``'s default.
"""
from __future__ import annotations

import builtins

import torch

from ..core import dtype as _dtype
from ..core.dispatch import primitive
from .math import _floating, _tensor


def _dims(x, axis):
    """``axis`` as a tuple of dims of ``x`` (all of them for None)."""
    if axis is None:
        return tuple(range(x.dim()))
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) % builtins.max(x.dim(), 1) for a in axis)
    return (int(axis) % builtins.max(x.dim(), 1),)


def _reduce_each(fn, x, dims, keepdim):
    """``fn(x, dim, keepdim)`` over several dims, one at a time (for torch
    reductions that take one dim)."""
    for d in sorted(dims, reverse=True):
        x = fn(x, d, keepdim)
    return x


def _reduce(name, fn, nondiff=False):
    def op(x, axis=None, keepdim=False):
        x = _tensor(x)
        return fn(x, _dims(x, axis), keepdim)

    op.__name__ = op.__qualname__ = name
    return primitive(op, name=name, nondiff=nondiff)


def _sum(x, dims, keepdim):
    return torch.sum(x, dim=dims, keepdim=keepdim) if dims else x.clone()


def _mean(x, dims, keepdim):
    x = _floating(x)
    return torch.mean(x, dim=dims, keepdim=keepdim) if dims else x.clone()


def _prod(x, dims, keepdim):
    dt = torch.int64 if x.dtype == torch.bool else None
    out = _reduce_each(lambda t, d, k: torch.prod(t, d, keepdim=k, dtype=dt),
                       x, dims, keepdim)
    return out if dims else x.clone()


def _amax(x, dims, keepdim):
    return torch.amax(x, dim=dims, keepdim=keepdim) if dims else x.clone()


def _amin(x, dims, keepdim):
    return torch.amin(x, dim=dims, keepdim=keepdim) if dims else x.clone()


def _nansum(x, dims, keepdim):
    return torch.nansum(x, dim=dims, keepdim=keepdim)


def _nanmean(x, dims, keepdim):
    return torch.nanmean(_floating(x), dim=dims, keepdim=keepdim)


def _all(x, dims, keepdim):
    x = x != 0 if x.dtype != torch.bool else x
    return _reduce_each(lambda t, d, k: torch.all(t, d, keepdim=k), x, dims,
                        keepdim) if dims else x.clone()


def _any(x, dims, keepdim):
    x = x != 0 if x.dtype != torch.bool else x
    return _reduce_each(lambda t, d, k: torch.any(t, d, keepdim=k), x, dims,
                        keepdim) if dims else x.clone()


sum_ = _reduce("sum", _sum)
mean = _reduce("mean", _mean)
prod = _reduce("prod", _prod)
max_ = _reduce("max", _amax)
min_ = _reduce("min", _amin)
amax = _reduce("amax", _amax)
amin = _reduce("amin", _amin)
nansum = _reduce("nansum", _nansum)
nanmean = _reduce("nanmean", _nanmean)
all_ = _reduce("all", _all, nondiff=True)
any_ = _reduce("any", _any, nondiff=True)


def sum(x, axis=None, keepdim=False, dtype=None):  # noqa: A001
    out = sum_(x, axis=axis, keepdim=keepdim)
    if dtype is not None:
        from .math import cast

        out = cast(out, dtype=dtype)
    return out


def max(x, axis=None, keepdim=False):  # noqa: A001
    return max_(x, axis=axis, keepdim=keepdim)


def min(x, axis=None, keepdim=False):  # noqa: A001
    return min_(x, axis=axis, keepdim=keepdim)


def all(x, axis=None, keepdim=False):  # noqa: A001
    return all_(x, axis=axis, keepdim=keepdim)


def any(x, axis=None, keepdim=False):  # noqa: A001
    return any_(x, axis=axis, keepdim=keepdim)


@primitive
def std(x, axis=None, unbiased=True, keepdim=False):
    x = _floating(_tensor(x))
    return torch.std(x, dim=_dims(x, axis), correction=int(unbiased),
                     keepdim=keepdim)


@primitive
def var(x, axis=None, unbiased=True, keepdim=False):
    x = _floating(_tensor(x))
    return torch.var(x, dim=_dims(x, axis), correction=int(unbiased),
                     keepdim=keepdim)


@primitive
def logsumexp(x, axis=None, keepdim=False):
    x = _floating(_tensor(x))
    return torch.logsumexp(x, dim=_dims(x, axis), keepdim=keepdim)


def _quantile(fn, x, q, axis, keepdim):
    """``fn`` (torch's quantile or nanquantile) over ``axis`` (None, an
    int or several), with ``jnp``'s output layout: q's shape first, then
    the kept axes."""
    x = _floating(_tensor(x))
    dims = _dims(x, axis)
    rest = [d for d in range(x.dim()) if d not in dims]
    moved = x.permute(rest + list(dims))
    flat = moved.reshape(moved.shape[:len(rest)] + (-1,))
    qt = q if isinstance(q, torch.Tensor) else torch.as_tensor(
        q, dtype=flat.dtype, device=x.device)
    out = fn(flat, qt.to(flat.dtype), dim=-1)
    if keepdim:
        shape = list(out.shape)
        lead = shape[:qt.dim()]
        kept = [1 if d in dims else x.shape[d] for d in range(x.dim())]
        out = out.reshape(lead + kept)
    return out


@primitive
def median(x, axis=None, keepdim=False):
    return _quantile(torch.quantile, x, 0.5, axis, keepdim)


@primitive
def quantile(x, q, axis=None, keepdim=False):
    return _quantile(torch.quantile, x, q, axis, keepdim)


def _arg(fn, x, axis, keepdim, dtype):
    x = _tensor(x)
    if axis is None:
        out = fn(x.reshape(-1), dim=0)
        if keepdim:
            out = out.reshape((1,) * x.dim())
    else:
        out = fn(x, dim=int(axis), keepdim=keepdim)
    return out.to(_dtype.to_torch(dtype))


@primitive(nondiff=True)
def argmax(x, axis=None, keepdim=False, dtype="int64"):
    return _arg(torch.argmax, x, axis, keepdim, dtype)


@primitive(nondiff=True)
def argmin(x, axis=None, keepdim=False, dtype="int64"):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


@primitive(nondiff=True)
def count_nonzero(x, axis=None, keepdim=False):
    x = _tensor(x)
    dims = _dims(x, axis)
    out = torch.count_nonzero(x, dim=dims) if dims else (x != 0).long()
    if keepdim:
        for d in sorted(dims):
            out = out.unsqueeze(d)
    return out.to(torch.int64)
