"""The rest of the reference's ``paddle.*`` tensor API (counterpart of
paddle_tpu/ops/extras.py): complex views, integer math, index grids, the
sharding helper and the in-place spellings. Random draws come from
``framework.random``'s generators."""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as _dtype
from ..core.dispatch import primitive
from ..framework import random as _random
from .math import _tensor, add_n, angle, gcd, imag, lcm  # noqa: F401


@primitive
def as_complex(x):
    """``[..., 2]`` float -> ``[...]`` complex."""
    x = _tensor(x)
    return torch.complex(x[..., 0], x[..., 1])


@primitive
def as_real(x):
    """``[...]`` complex -> ``[..., 2]`` float."""
    x = _tensor(x)
    if not x.is_complex():
        return torch.stack([x, torch.zeros_like(x)], dim=-1)
    return torch.stack([x.real, x.imag], dim=-1)


@primitive
def complex(real, imag):  # noqa: A001
    real = _tensor(real)
    return torch.complex(real.float(), _tensor(imag, real).float())


@primitive
def sgn(x):
    """x / |x| for complex (0 at 0), sign(x) for real."""
    return torch.sgn(_tensor(x))


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


@primitive
def floor_mod(x, y):
    x = _tensor(x)
    return torch.remainder(x, _tensor(y, x))


@primitive
def frexp(x):
    """``x = m * 2**e`` with ``0.5 <= |m| < 1``; e int32."""
    m, e = torch.frexp(_tensor(x))
    return m, e.to(torch.int32)


@primitive
def nanquantile(x, q, axis=None, keepdim=False):
    from .reduction import _quantile

    return _quantile(torch.nanquantile, _tensor(x).float(), q, axis,
                     keepdim)


@primitive(nondiff=True)
def poisson(x):
    x = _tensor(x)
    return torch.poisson(x, generator=_random.generator(x.device))


@primitive(nondiff=True)
def randint_like(x, low=0, high=None, dtype=None):
    """Integers in ``[low, high)`` shaped as ``x``, in ``x``'s dtype unless
    ``dtype`` is given."""
    x = _tensor(x)
    if high is None:
        low, high = 0, low
    out = torch.randint(int(low), int(high), x.shape, device=x.device,
                        generator=_random.generator(x.device))
    return out.to(x.dtype if dtype is None else _dtype.to_torch(dtype))


@primitive
def take(x, index, mode="raise"):
    """Gather from the flattened ``x``: ``raise`` checks the bounds,
    ``wrap`` and ``clip`` follow numpy."""
    v = _tensor(x).reshape(-1)
    idx = _tensor(index, v).to(v.device).long()
    n = v.shape[0]
    if mode == "wrap":
        idx = ((idx % n) + n) % n
    elif mode == "clip":
        idx = idx.clamp(0, n - 1)
    elif mode == "raise":
        if bool(((idx < -n) | (idx >= n)).any()):
            raise IndexError(
                "take(mode='raise'): index out of range for %d elements" % n)
        idx = torch.where(idx < 0, idx + n, idx)
    else:
        raise ValueError("take: unknown mode %r" % (mode,))
    return v[idx]


def _indices(fn, row, col, offset, dtype):
    from ..core.place import current_torch_device

    col = row if col is None else col
    return fn(row, col, offset, device=current_torch_device()).to(
        _dtype.to_torch(dtype))


def tril_indices(row, col=None, offset=0, dtype="int64"):
    return _indices(torch.tril_indices, row, col, offset, dtype)


def triu_indices(row, col=None, offset=0, dtype="int64"):
    return _indices(torch.triu_indices, row, col, offset, dtype)


def vsplit(x, num_or_sections):
    from .manipulation import split

    return split(x, num_or_sections, axis=0)


@primitive
def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    if not 0 <= shard_id < nshards:
        raise ValueError(
            "shard_id (%d) must be in [0, %d)" % (shard_id, nshards))
    v = _tensor(input)
    shard_size = (index_num + nshards - 1) // nshards
    lo = shard_id * shard_size
    inside = (v >= lo) & (v < lo + shard_size)
    return torch.where(inside, v - lo, torch.full_like(v, ignore_value))


def shape(x):
    """The shape as an int32 tensor (the op form)."""
    x = _tensor(x)
    return torch.tensor(list(x.shape), dtype=torch.int32, device=x.device)


def rank(x):
    x = _tensor(x)
    return torch.tensor(x.dim(), device=x.device)


def is_complex(x):
    return _tensor(x).is_complex()


def is_floating_point(x):
    return _tensor(x).is_floating_point()


def is_integer(x):
    x = _tensor(x)
    return not (x.is_floating_point() or x.is_complex()
                or x.dtype == torch.bool)


def tolist(x):
    return _tensor(x).tolist()


def iinfo(dtype):
    return torch.iinfo(_dtype.to_torch(dtype))


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """Display knobs for printed tensors (torch's)."""
    torch.set_printoptions(precision=precision, threshold=threshold,
                           edgeitems=edgeitems, linewidth=linewidth,
                           sci_mode=sci_mode)


def check_shape(shape):
    """Shape entries must be ints, positive or -1."""
    for s in shape:
        if not isinstance(s, (int, np.integer)):
            raise TypeError("shape entries must be integers, got %r" % (s,))
        if s < -1 or s == 0:
            raise ValueError(
                "shape entries must be positive or -1, got %d" % s)
    return True


@primitive
def crop(x, shape=None, offsets=None, name=None):
    """The box at ``offsets`` (default 0) of ``shape`` (-1: to the end)."""
    v = _tensor(x)
    shp = list(shape) if shape is not None else list(v.shape)
    offs = list(offsets) if offsets is not None else [0] * v.dim()
    sizes = [v.shape[i] - offs[i] if shp[i] == -1 else shp[i]
             for i in range(v.dim())]
    for i in range(v.dim()):
        if offs[i] + sizes[i] > v.shape[i]:
            raise ValueError(
                "crop: offsets[%d] + shape[%d] (%d) exceeds input dim %d"
                % (i, i, offs[i] + sizes[i], v.shape[i]))
    return v[tuple(slice(o, o + s) for o, s in zip(offs, sizes))]


def disable_signal_handler():
    """The port installs no signal handlers: nothing to disable."""


def _make_inplace(fn_name, fn):
    """``fn``'s result written into its first argument, which is
    returned (the reference's ``*_`` spellings). A result of ``x``'s shape
    and dtype is copied in, recorded by autograd as torch's own in-place
    ops are; one of another shape or dtype (``reshape_``, ``cast_``)
    replaces ``x``'s data, as the reference replaces its value, and is
    not recorded."""
    def op(x, *args, **kwargs):
        out = fn(x, *args, **kwargs)
        if out.shape == x.shape and out.dtype == x.dtype:
            return x.copy_(out)
        x.data = out.detach()
        return x

    op.__name__ = fn_name
    op.__doc__ = "In-place spelling of %s." % fn_name.rstrip("_")
    return op
