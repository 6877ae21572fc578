"""Shape and layout ops (counterpart of paddle_tpu/ops/manipulation.py).

Each function the reference registers as a primitive is one here, under
its name. Ops whose output shape depends on the data (``nonzero``,
``masked_select``, ``unique``, ``unique_consecutive``) run on the
tensor's device and return tensors of the data's size, as the reference's
host fallbacks do. ``sort`` and ``argsort`` are stable, the descending
order being the ascending one reversed, as the reference builds it (so
equal values come last index first); ``kthvalue`` takes the stable order's
``k``-th. ``topk`` on the card guarantees no order among ties.

``pad`` follows the reference's two list forms: ``2 * ndim`` widths
give ``(before, after)`` for every axis in order; a shorter list gives
pairs for the last spatial axes, the last axis first (Paddle's ``[left,
right, top, bottom]``), and with a channel-last ``data_format`` those are
the axes before the channels. Its non-constant modes are numpy's
(``reflect`` leaves the edge out, ``replicate`` repeats it, ``circular``
wraps), as ``jnp.pad`` gives them, for any axis and any width.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ..core.dispatch import primitive
from .math import _tensor

CHANNEL_LAST = ("NHWC", "NLC", "NDHWC")


def _pad_index(n, before, after, mode, device):
    """The source index of every position of an axis of ``n`` padded by
    ``before`` and ``after`` in ``mode``."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "replicate":
        return i.clamp(0, n - 1)
    if mode == "circular":
        return i.remainder(n)
    if n == 1:                                  # reflect
        return torch.zeros_like(i)
    j = i.remainder(2 * (n - 1))
    return torch.where(j >= n, 2 * (n - 1) - j, j)


@primitive
def pad(x, pad, mode="constant", value=0.0, data_format="NCHW"):
    pad = [int(p) for p in pad]
    if len(pad) == 2 * x.dim():
        widths = [(pad[2 * i], pad[2 * i + 1]) for i in range(x.dim())]
    else:
        pairs = [(pad[2 * i], pad[2 * i + 1]) for i in range(len(pad) // 2)]
        if data_format in CHANNEL_LAST:
            widths = ([(0, 0)] * (x.dim() - len(pairs) - 1)
                      + pairs[::-1] + [(0, 0)])
        else:
            widths = [(0, 0)] * (x.dim() - len(pairs)) + pairs[::-1]
    if mode not in ("constant", "reflect", "replicate", "circular"):
        raise KeyError(mode)
    if mode == "constant":
        flat = [w for pair in reversed(widths) for w in pair]
        return TF.pad(x, flat, mode="constant", value=value)
    for axis, (before, after) in enumerate(widths):
        if before or after:
            x = x.index_select(axis, _pad_index(x.shape[axis], before, after,
                                                mode, x.device))
    return x


@primitive(nondiff=True)
def one_hot(x, num_classes):
    """float32 ``[..., num_classes]``; an id outside ``[0, num_classes)``
    gives a row of zeros, as ``jax.nn.one_hot`` does."""
    ids = x.long().unsqueeze(-1)
    classes = torch.arange(int(num_classes), device=x.device)
    return (ids == classes).to(torch.float32)


@primitive
def diag_embed(x, offset=0, dim1=-2, dim2=-1):
    """The last axis of ``x`` on the ``offset`` diagonal of a new
    trailing square, whose two axes are then moved to ``dim1`` and
    ``dim2`` by the reference's permutation."""
    n = x.shape[-1] + abs(offset)
    out = x.new_zeros(x.shape[:-1] + (n, n))
    i = torch.arange(x.shape[-1], device=x.device)
    out[..., i + max(-offset, 0), i + max(offset, 0)] = x
    nd = out.dim()
    d1, d2 = dim1 % nd, dim2 % nd
    if (d1, d2) != (nd - 2, nd - 1):
        perm = [a for a in range(nd) if a not in (nd - 2, nd - 1)]
        for pos, src in sorted([(d1, nd - 2), (d2, nd - 1)]):
            perm.insert(pos, src)
        out = out.permute(perm)
    return out


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v] * 2


def _pads4(paddings):
    """``[top, bottom, left, right]`` from an int, a pair or four ints."""
    pd = _pair(paddings)
    return [pd[0], pd[0], pd[1], pd[1]] if len(pd) == 2 else pd


@primitive
def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    """im2col of ``[N, C, H, W]``: ``[N, C * kh * kw, L]``, channels
    outermost, as the reference's ``conv_general_dilated_patches``
    orders them (torch's ``unfold`` does the same; padding may be
    uneven, so it is applied first)."""
    pd = _pads4(paddings)
    x = TF.pad(x, [pd[2], pd[3], pd[0], pd[1]])
    return TF.unfold(x, _pair(kernel_sizes), dilation=_pair(dilations),
                     stride=_pair(strides))


# -- the rest of the reference's manipulation ops ------------------------

def _index(index, like):
    return _tensor(index, like).to(device=like.device).long()


@primitive
def reshape(x, shape):
    return torch.reshape(_tensor(x), [int(s) for s in shape])


@primitive
def transpose(x, perm):
    return _tensor(x).permute([int(p) for p in perm])


def t(x):
    x = _tensor(x)
    if x.dim() < 2:
        return x
    return transpose(x, list(range(x.dim()))[::-1])


@primitive
def concat(xs, axis=0):
    return torch.cat([_tensor(x) for x in xs], dim=int(axis))


@primitive
def stack(xs, axis=0):
    return torch.stack([_tensor(x) for x in xs], dim=int(axis))


@primitive
def _split_impl(x, sections, axis):
    x = _tensor(x)
    if isinstance(sections, int):
        if x.shape[axis] % sections:
            raise ValueError(
                "split: axis %d of size %d does not divide into %d "
                "sections" % (axis, x.shape[axis], sections))
        return tuple(torch.split(x, x.shape[axis] // sections, dim=axis))
    sizes = [int(s) for s in sections]
    if -1 in sizes:
        sizes[sizes.index(-1)] = x.shape[axis] - sum(
            s for s in sizes if s != -1)
    return tuple(torch.split(x, sizes, dim=axis))


def split(x, num_or_sections, axis=0):
    return list(_split_impl(x, sections=num_or_sections, axis=int(axis)))


def chunk(x, chunks, axis=0):
    return split(x, chunks, axis)


def unbind(x, axis=0):
    return [squeeze(p, axis=axis) for p in split(x, x.shape[axis], axis)]


@primitive
def squeeze(x, axis=None):
    x = _tensor(x)
    if axis is None:
        return torch.squeeze(x)
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    axes = tuple(a % x.dim() for a in axes if x.shape[a % x.dim()] == 1)
    return torch.squeeze(x, axes) if axes else x


@primitive
def unsqueeze(x, axis):
    out = _tensor(x)
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    for a in sorted(int(a) if a >= 0 else int(a) + out.dim() + 1
                    for a in axes):
        out = out.unsqueeze(a)
    return out


@primitive
def flatten(x, start_axis=0, stop_axis=-1):
    x = _tensor(x)
    if x.dim() == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis, stop_axis)


@primitive
def tile(x, repeat_times):
    return torch.tile(_tensor(x), tuple(int(r) for r in repeat_times))


@primitive
def expand(x, shape):
    x = _tensor(x)
    shape = list(shape)
    xs = (1,) * (len(shape) - x.dim()) + tuple(x.shape)
    return x.expand([xs[i] if int(s) == -1 else int(s)
                     for i, s in enumerate(shape)])


def expand_as(x, y):
    return expand(x, y.shape)


def broadcast_to(x, shape):
    return expand(x, shape)


def broadcast_tensors(inputs):
    shape = torch.broadcast_shapes(*[tuple(i.shape) for i in inputs])
    return [expand(i, list(shape)) for i in inputs]


@primitive
def flip(x, axis):
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    return torch.flip(_tensor(x), [int(a) for a in axes])


@primitive
def roll(x, shifts, axis=None):
    if axis is None:
        return torch.roll(_tensor(x), shifts)
    return torch.roll(_tensor(x), shifts, axis)


@primitive
def rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(_tensor(x), k, list(axes))


def _take(x, index, axis):
    x = _tensor(x)
    index = _index(index, x)
    axis = int(axis) % x.dim()
    out = x.index_select(axis, index.reshape(-1))
    return out.reshape(x.shape[:axis] + index.shape + x.shape[axis + 1:])


@primitive
def gather(x, index, axis=0):
    return _take(x, index, axis)


@primitive
def index_select(x, index, axis=0):
    return _take(x, index, axis)


@primitive
def gather_nd(x, index):
    x = _tensor(x)
    index = _index(index, x)
    return x[tuple(index.movedim(-1, 0))]


@primitive
def take_along_axis(x, indices, axis):
    x = _tensor(x)
    return torch.take_along_dim(x, _index(indices, x), int(axis))


@primitive
def put_along_axis(x, indices, values, axis, reduce="assign"):
    x = _tensor(x)
    indices = _index(indices, x)
    values = _tensor(values, x).to(x.dtype).expand(indices.shape)
    axis = int(axis)
    if reduce == "assign":
        return x.scatter(axis, indices, values)
    if reduce in ("add", "sum"):
        return x.scatter_add(axis, indices, values)
    if reduce in ("mul", "multiply"):
        return x.scatter_reduce(axis, indices, values, "prod")
    raise ValueError("unsupported reduce %r" % reduce)


@primitive
def scatter(x, index, updates, overwrite=True):
    x = _tensor(x)
    index = _index(index, x).reshape(-1)
    updates = _tensor(updates, x).to(x.dtype)
    if overwrite:
        return x.index_put((index,), updates)
    zeroed = x.index_put((index,), torch.zeros_like(updates))
    return zeroed.index_put((index,), updates, accumulate=True)


@primitive
def scatter_nd_add(x, index, updates):
    x = _tensor(x)
    index = _index(index, x)
    return x.index_put(tuple(index.movedim(-1, 0)),
                       _tensor(updates, x).to(x.dtype), accumulate=True)


def scatter_nd(index, updates, shape):
    base = torch.zeros([int(s) for s in shape], dtype=updates.dtype,
                       device=updates.device)
    return scatter_nd_add(base, index, updates)


@primitive
def where(condition, x=None, y=None):
    condition = _tensor(condition)
    return torch.where(condition.bool(), _tensor(x, condition),
                       _tensor(y, condition))


@primitive
def masked_fill(x, mask, value):
    x = _tensor(x)
    return torch.where(_tensor(mask, x).bool(), _tensor(value, x), x)


def masked_select(x, mask):
    return torch.masked_select(x, _tensor(mask, x).bool())


def nonzero(x, as_tuple=False):
    x = _tensor(x)
    if as_tuple:
        return tuple(torch.nonzero(x, as_tuple=True))
    return torch.nonzero(x)


def _first_index(inverse, n):
    """The first position of each of ``n`` groups in ``inverse``."""
    pos = torch.arange(inverse.numel(), device=inverse.device)
    first = torch.full((n,), inverse.numel(), dtype=torch.int64,
                       device=inverse.device)
    return first.scatter_reduce(0, inverse.reshape(-1), pos, "amin")


def unique(x, return_index=False, return_inverse=False,
           return_counts=False, axis=None):
    """numpy's ``unique``: sorted; ``return_index`` gives each value's
    first position (in the flattened input when ``axis`` is None)."""
    x = _tensor(x)
    src = x.reshape(-1) if axis is None else x
    vals, inverse, counts = torch.unique(
        src, sorted=True, return_inverse=True, return_counts=True,
        dim=axis)
    outs = [vals]
    if return_index:
        outs.append(_first_index(inverse, vals.shape[0 if axis is None
                                                     else axis]))
    if return_inverse:
        outs.append(inverse)
    if return_counts:
        outs.append(counts)
    return outs[0] if len(outs) == 1 else tuple(outs)


@primitive
def sort(x, axis=-1, descending=False):
    out = torch.sort(_tensor(x), dim=int(axis), stable=True).values
    return torch.flip(out, [int(axis)]) if descending else out


@primitive(nondiff=True)
def argsort(x, axis=-1, descending=False):
    out = torch.sort(_tensor(x), dim=int(axis), stable=True).indices
    return torch.flip(out, [int(axis)]) if descending else out


@primitive
def topk(x, k, axis=-1, largest=True, sorted=True):
    vals, idx = torch.topk(_tensor(x), int(k), dim=int(axis),
                           largest=largest, sorted=True)
    return vals, idx.to(torch.int64)


def kthvalue(x, k, axis=-1, keepdim=False):
    vals = sort(x, axis=axis)
    idx = argsort(x, axis=axis)
    sel_v = slice_(vals, axes=[axis], starts=[k - 1], ends=[k])
    sel_i = slice_(idx, axes=[axis], starts=[k - 1], ends=[k])
    if not keepdim:
        sel_v = squeeze(sel_v, axis=axis)
        sel_i = squeeze(sel_i, axis=axis)
    return sel_v, sel_i


@primitive(name="slice")
def slice_(x, axes, starts, ends):
    x = _tensor(x)
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(axes, starts, ends):
        idx[a] = slice(int(s), int(e))
    return x[tuple(idx)]


@primitive
def strided_slice(x, axes, starts, ends, strides):
    """Python slicing per axis, negative strides included."""
    x = _tensor(x)
    for a, s, e, st in zip(axes, starts, ends, strides):
        n = x.shape[a]
        picks = list(range(*slice(int(s), int(e), int(st)).indices(n)))
        x = x.index_select(a, torch.tensor(picks, dtype=torch.int64,
                                           device=x.device))
    return x


@primitive
def repeat_interleave(x, repeats, axis=None):
    x = _tensor(x)
    if not isinstance(repeats, int):
        repeats = _index(repeats, x)
    if axis is None:
        return torch.repeat_interleave(x.reshape(-1), repeats, dim=0)
    return torch.repeat_interleave(x, repeats, dim=int(axis))


@primitive
def moveaxis(x, source, destination):
    return torch.movedim(_tensor(x), source, destination)


@primitive
def swapaxes(x, axis0, axis1):
    return torch.swapaxes(_tensor(x), int(axis0), int(axis1))


@primitive(nondiff=True)
def searchsorted(sorted_sequence, values, out_int32=False, right=False):
    seq = _tensor(sorted_sequence)
    return torch.searchsorted(seq, _tensor(values, seq).to(seq.dtype),
                              right=right, out_int32=out_int32)


@primitive(nondiff=True)
def bucketize(x, sorted_sequence, out_int32=False, right=False):
    seq = _tensor(sorted_sequence)
    return torch.searchsorted(seq, _tensor(x, seq).to(seq.dtype),
                              right=right, out_int32=out_int32)


@primitive
def index_add(x, index, axis, value):
    x = _tensor(x)
    return x.index_add(int(axis), _index(index, x),
                       _tensor(value, x).to(x.dtype))


@primitive
def index_put(x, indices, value, accumulate=False):
    x = _tensor(x)
    idx = tuple(_tensor(i, x).to(x.device) for i in indices)
    idx = tuple(i if i.dtype == torch.bool else i.long() for i in idx)
    value = _tensor(value, x).to(x.dtype)
    if not accumulate:
        value = value.expand(x[idx].shape)
    return x.index_put(idx, value, accumulate=accumulate)


@primitive
def as_strided(x, shape, stride, offset=0):
    flat = _tensor(x).reshape(-1)
    shape = [int(s) for s in shape]
    lin = torch.full(shape, int(offset), dtype=torch.int64,
                     device=flat.device)
    for d, (n, st) in enumerate(zip(shape, stride)):
        view = [1] * len(shape)
        view[d] = n
        lin = lin + torch.arange(n, device=flat.device).reshape(view) * st
    return flat[lin]


@primitive
def diff(x, n=1, axis=-1):
    return torch.diff(_tensor(x), n=n, dim=axis)


@primitive
def unstack(x, axis=0, num=None):
    return tuple(torch.unbind(_tensor(x), dim=axis))


@primitive
def reverse(x, axis):
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    return torch.flip(_tensor(x), list(axes))


@primitive
def fill(x, value):
    return torch.full_like(_tensor(x), value)


@primitive
def fill_diagonal(x, value, offset=0, wrap=False):
    x = _tensor(x)
    if x.dim() == 2:
        rows, cols = x.shape
        i = torch.arange(rows, device=x.device)[:, None]
        j = torch.arange(cols, device=x.device)[None, :]
        mask = (j - i) == offset
        if wrap and rows > cols:
            mask = ((i - j) % (cols + 1)) == (-offset % (cols + 1))
        return torch.where(mask, torch.tensor(value, dtype=x.dtype,
                                              device=x.device), x)
    if offset != 0 or wrap:
        raise ValueError(
            "fill_diagonal: offset/wrap are only supported for 2-D "
            "inputs (got ndim=%d)" % x.dim())
    grids = torch.meshgrid(*[torch.arange(s, device=x.device)
                             for s in x.shape], indexing="ij")
    mask = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    for g in grids[1:]:
        mask &= grids[0] == g
    return torch.where(mask, torch.tensor(value, dtype=x.dtype,
                                          device=x.device), x)


@primitive
def multiplex(inputs, index):
    stacked = torch.stack([_tensor(t) for t in inputs], dim=0)
    idx = _index(index, stacked).reshape(-1)
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    return stacked[idx, rows]


@primitive
def index_sample(x, index):
    x = _tensor(x)
    return torch.take_along_dim(x, _index(index, x), 1)


@primitive(nondiff=True)
def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None):
    x = _tensor(x)
    src = x.reshape(-1) if axis is None else x
    out, inverse, counts = torch.unique_consecutive(
        src, return_inverse=True, return_counts=True, dim=axis)
    outs = [out]
    if return_inverse:
        outs.append(inverse)
    if return_counts:
        outs.append(counts)
    return tuple(outs) if len(outs) > 1 else outs[0]


@primitive
def fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1):
    x = _tensor(x)
    moved = torch.movedim(x, (dim1, dim2), (-2, -1))
    rows, cols = moved.shape[-2], moved.shape[-1]
    n = min(rows - max(-offset, 0), cols - max(offset, 0))
    i = torch.arange(n, device=x.device)
    r, c = i + max(-offset, 0), i + max(offset, 0)
    out = moved.clone()
    out[..., r, c] = _tensor(y, x).to(x.dtype)
    return torch.movedim(out, (-2, -1), (dim1, dim2))
