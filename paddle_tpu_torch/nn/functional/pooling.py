"""Pooling (counterpart of paddle_tpu/nn/functional/pooling.py).

The reference pools with ``jax.lax.reduce_window`` outside any Pallas
kernel, so the port calls torch's pooling functions.

- **Padding** takes the convolutions' forms (``conv.resolve_pads``: ints,
  pairs, ``2n`` lists, ``SAME`` split as XLA splits it, ``VALID``). A
  symmetric padding of at most half the window goes to torch's pooling,
  which pads max pooling with -inf and, with ``count_include_pad=False``,
  counts only real elements; any other padding is made explicit with
  ``F.pad`` first (-inf for max, zeros for average).
- **Max pooling** with ``return_mask`` (2-D, as in the reference) pads
  with the lowest finite float32 and returns each maximum's flat index in
  the input's ``H * W`` plane, the first maximum of the window on ties.
  ``max_pool1d`` / ``max_pool3d`` accept ``return_mask`` and return the
  output alone, as the reference does.
- **Average pooling** with ``exclusive=True`` (the default) divides each
  window's sum by the count of its real elements, torch's
  ``count_include_pad=False``; ``exclusive=False`` divides by the window
  size.
- **Adaptive pooling** takes the bins ``floor(i * in / out)`` to
  ``ceil((i + 1) * in / out)``, which are torch's ``adaptive_*_pool``
  bins. ``adaptive_max_pool1d/2d`` accept ``return_mask`` and return the
  output alone; ``adaptive_max_pool3d`` raises for it; as in the reference.
- **``ceil_mode`` and ``divisor_override``** are accepted and never read,
  as in the reference, whose ``_pool`` takes neither ("Faults of the
  reference" 8 in ROADMAP.md): the output has the floor-mode size, and an
  average divides as ``exclusive`` says.
- **``max_unpool1d/2d/3d``** scatter-add each value into a zero plane at
  its flat index, as the reference's ``.at[...].add`` does (an index
  outside the plane is dropped, as JAX drops it).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ...core.dispatch import primitive
from .conv import (_norm_padding, _norm_tuple, channels_back,
                   channels_first, resolve_pads, torch_pad_list)

_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG = {1: TF.avg_pool1d, 2: TF.avg_pool2d, 3: TF.avg_pool3d}


def _window(x, kernel_size, stride, padding, n):
    kernel = _norm_tuple(kernel_size, n)
    stride = _norm_tuple(kernel_size if stride is None else stride, n)
    pads = resolve_pads(padding, n, x.shape[2:], kernel, stride)
    return kernel, stride, pads


def _native(pads, kernel):
    """The symmetric padding torch's pooling can take, or None."""
    if all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, kernel)):
        return [lo for lo, _ in pads]
    return None


def _max_pool(x, kernel_size, stride, padding, n, channel_last):
    x = channels_first(x, channel_last)
    kernel, stride, pads = _window(x, kernel_size, stride, padding, n)
    native = _native(pads, kernel)
    if native is None:
        x = TF.pad(x, torch_pad_list(pads), value=-math.inf)
        native = 0
    return channels_back(_MAX[n](x, kernel, stride, native), channel_last)


def _avg_pool(x, kernel_size, stride, padding, n, exclusive, channel_last):
    x = channels_first(x, channel_last)
    kernel, stride, pads = _window(x, kernel_size, stride, padding, n)
    native = _native(pads, kernel)
    if native is not None:
        out = _AVG[n](x, kernel, stride, native,
                      count_include_pad=not exclusive)
        return channels_back(out, channel_last)
    pad = torch_pad_list(pads)
    out = _AVG[n](TF.pad(x, pad), kernel, stride)
    if exclusive:
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        out = out / _AVG[n](TF.pad(ones, pad), kernel, stride)
    return channels_back(out, channel_last)


@primitive
def max_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCL"):
    return _max_pool(x, kernel_size, stride, padding, 1,
                     data_format == "NLC")


@primitive
def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW"):
    channel_last = data_format == "NHWC"
    if not return_mask:
        return _max_pool(x, kernel_size, stride, padding, 2, channel_last)
    xv = channels_first(x, channel_last)
    kernel, stride, pads = _window(xv, kernel_size, stride, padding, 2)
    width = xv.shape[3]
    xp = TF.pad(xv.float(), torch_pad_list(pads),
                value=torch.finfo(torch.float32).min)
    out, idx = TF.max_pool2d(xp, kernel, stride, return_indices=True)
    # a flat index of the padded plane -> of the input's H * W plane
    wp = xp.shape[3]
    mask = (idx // wp - pads[0][0]) * width + (idx % wp - pads[1][0])
    return (channels_back(out.to(x.dtype), channel_last),
            channels_back(mask.int(), channel_last))


@primitive
def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCDHW"):
    return _max_pool(x, kernel_size, stride, padding, 3,
                     data_format == "NDHWC")


@primitive
def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL"):
    return _avg_pool(x, kernel_size, stride, padding, 1, exclusive,
                     data_format == "NLC")


@primitive
def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW"):
    return _avg_pool(x, kernel_size, stride, padding, 2, exclusive,
                     data_format == "NHWC")


@primitive
def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW"):
    return _avg_pool(x, kernel_size, stride, padding, 3, exclusive,
                     data_format == "NDHWC")


@primitive
def adaptive_avg_pool1d(x, output_size):
    return TF.adaptive_avg_pool1d(x, _norm_tuple(output_size, 1))


@primitive
def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    channel_last = data_format == "NHWC"
    out = TF.adaptive_avg_pool2d(channels_first(x, channel_last),
                                 _norm_tuple(output_size, 2))
    return channels_back(out, channel_last)


@primitive
def adaptive_avg_pool3d(x, output_size, data_format="NCDHW"):
    channel_last = data_format == "NDHWC"
    out = TF.adaptive_avg_pool3d(channels_first(x, channel_last),
                                 _norm_tuple(output_size, 3))
    return channels_back(out, channel_last)


@primitive
def adaptive_max_pool1d(x, output_size, return_mask=False):
    return TF.adaptive_max_pool1d(x, _norm_tuple(output_size, 1))


@primitive
def adaptive_max_pool2d(x, output_size, return_mask=False,
                        data_format="NCHW"):
    channel_last = data_format == "NHWC"
    out = TF.adaptive_max_pool2d(channels_first(x, channel_last),
                                 _norm_tuple(output_size, 2))
    return channels_back(out, channel_last)


@primitive
def adaptive_max_pool3d(x, output_size, return_mask=False,
                        data_format="NCDHW"):
    if return_mask:
        raise NotImplementedError(
            "adaptive_max_pool3d(return_mask=True): indices for the "
            "variable-window 3d path are not provided; use max_pool3d")
    channel_last = data_format == "NDHWC"
    out = TF.adaptive_max_pool3d(channels_first(x, channel_last),
                                 _norm_tuple(output_size, 3))
    return channels_back(out, channel_last)


def _max_unpool(x, indices, spatial):
    """A negative index counts from the end and an index still outside
    the plane is dropped, as JAX's scatter does."""
    n, c = x.shape[:2]
    total = math.prod(spatial)
    idx = indices.reshape(n, c, -1).long()
    idx = torch.where(idx < 0, idx + total, idx)
    inside = (idx >= 0) & (idx < total)
    vals = torch.where(inside, x.reshape(n, c, -1), 0)
    flat = torch.zeros((n, c, total), dtype=x.dtype, device=x.device)
    flat = flat.scatter_add(2, torch.where(inside, idx, 0), vals)
    return flat.reshape((n, c) + tuple(spatial))


@primitive
def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None):
    if data_format != "NCL":
        raise ValueError("max_unpool1d only supports NCL (reference check)")
    k = _norm_tuple(kernel_size, 1)[0]
    s = k if stride is None else _norm_tuple(stride, 1)[0]
    p = _norm_tuple(padding, 1)[0]
    length = ((x.shape[-1] - 1) * s - 2 * p + k if output_size is None
              else int(output_size[-1]))
    return _max_unpool(x, indices, [length])


@primitive
def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None):
    channel_last = data_format == "NHWC"
    xv = channels_first(x, channel_last)
    idx = channels_first(indices, channel_last)
    kernel = _norm_tuple(kernel_size, 2)
    stride = _norm_tuple(kernel_size if stride is None else stride, 2)
    if output_size is None:
        # a string padding unpools as none, as in the reference
        pads = ([(0, 0)] * 2 if isinstance(padding, str)
                else _norm_padding(padding, 2))
        spatial = [(o - 1) * s - lo - hi + k for o, s, (lo, hi), k
                   in zip(xv.shape[2:], stride, pads, kernel)]
    else:
        spatial = [int(v) for v in output_size[-2:]]
    return channels_back(_max_unpool(xv, idx, spatial), channel_last)


@primitive
def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None):
    if data_format != "NCDHW":
        raise ValueError("max_unpool3d only supports NCDHW (reference "
                         "check)")
    kernel = _norm_tuple(kernel_size, 3)
    stride = _norm_tuple(kernel_size if stride is None else stride, 3)
    pad = _norm_tuple(padding, 3)
    if output_size is None:
        spatial = [(o - 1) * s - 2 * p + k for o, s, p, k
                   in zip(x.shape[2:], stride, pad, kernel)]
    else:
        spatial = [int(v) for v in output_size[-3:]]
    return _max_unpool(x, indices, spatial)
