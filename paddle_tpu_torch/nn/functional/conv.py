"""Convolutions (counterpart of paddle_tpu/nn/functional/conv.py).

The reference computes them with ``jax.lax.conv_general_dilated``, outside
any Pallas kernel, so the port calls ``torch.nn.functional.conv*d`` and
``conv_transpose*d`` (cuDNN on the card, run with TF32 off as
``paddle_tpu_torch/__init__.py`` sets it). Both weight layouts are
torch's own: ``[out, in / groups, *k]`` forward and ``[in, out / groups,
*k]`` transposed, so no weight is copied.

Padding takes the reference's forms (``_norm_padding``): an int, one int
per spatial dim, ``2n`` ints ``[lo_0, hi_0, lo_1, hi_1, ...]``, ``n``
pairs, or ``"SAME"`` / ``"VALID"``. torch's convolutions take only
symmetric padding (and ``'same'`` only at stride 1), so the symmetric part
goes to the convolution and any remainder to ``F.pad``. ``SAME`` splits
as XLA does: ``total = max((ceil(in / s) - 1) * s + k_eff - in, 0)``,
``total // 2`` before and the rest, the extra row, after.

A transposed convolution in the reference is a convolution over the
input dilated by ``stride`` with the flipped kernel and the padding
``(k_eff - 1 - lo, k_eff - 1 - hi + output_padding)`` per dim; a string
padding goes to XLA unchanged, which refuses it at a stride above 1 (so
the port raises there too) and at stride 1 sizes ``SAME`` / ``VALID`` on
the input, ignoring ``output_padding``. Here the
full transposed product (``conv_transpose`` at padding 0, the reference's
padding ``k_eff - 1`` on both sides) is cut to that padding with
``F.pad`` (a negative pad crops, a positive one adds zero rows), and the
bias is added after.

The channel-last formats (``NLC``, ``NHWC``, ``NDHWC``) move the channels
to axis 1 as a view (channels-last memory, which cuDNN takes as it is)
and back.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...core.dispatch import primitive

_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
           3: TF.conv_transpose3d}


def _norm_tuple(v, n):
    if isinstance(v, (int, float)):
        return (int(v),) * n
    v = tuple(int(i) for i in v)
    return v * n if len(v) == 1 else v


def _norm_padding(padding, n):
    """The reference's padding forms as ``n`` ``(lo, hi)`` pairs, or the
    upper-cased string."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * n:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    return [tuple(int(q) for q in p) for p in padding]


def same_pads(sizes, kernel, stride, dilation=None):
    """XLA's ``SAME`` split per dim (``lax.padtype_to_pads`` on the
    dilated kernel): the odd row goes after."""
    dilation = dilation or (1,) * len(sizes)
    pads = []
    for size, k, s, d in zip(sizes, kernel, stride, dilation):
        k_eff = (k - 1) * d + 1
        total = max((-(-size // s) - 1) * s + k_eff - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def resolve_pads(padding, n, sizes, kernel, stride, dilation=None):
    """``padding`` as ``n`` ``(lo, hi)`` pairs for inputs of spatial
    ``sizes``."""
    pads = _norm_padding(padding, n)
    if pads == "SAME":
        return same_pads(sizes, kernel, stride, dilation)
    if pads == "VALID":
        return [(0, 0)] * n
    if isinstance(pads, str):
        raise ValueError("padding must be SAME or VALID, got %r" % padding)
    return pads


def torch_pad_list(pads):
    """``(lo, hi)`` pairs, first spatial dim first, as ``F.pad``'s list
    (last dim first)."""
    out = []
    for lo, hi in reversed(pads):
        out += [lo, hi]
    return out


def channels_first(x, channel_last):
    """``x`` with its channels on axis 1 (a view)."""
    return x.movedim(-1, 1) if channel_last else x


def channels_back(x, channel_last):
    return x.movedim(1, -1) if channel_last else x


def _add_bias(out, bias):
    if bias is None:
        return out
    return out + bias.reshape([1, -1] + [1] * (out.dim() - 2))


def _conv(x, weight, bias, stride, padding, dilation, groups, n,
          channel_last):
    stride = _norm_tuple(stride, n)
    dilation = _norm_tuple(dilation, n)
    x = channels_first(x, channel_last)
    pads = resolve_pads(padding, n, x.shape[2:], weight.shape[2:], stride,
                        dilation)
    sym = [min(lo, hi) for lo, hi in pads]
    rest = [(lo - s, hi - s) for (lo, hi), s in zip(pads, sym)]
    if any(lo or hi for lo, hi in rest):
        x = TF.pad(x, torch_pad_list(rest))
    out = _CONV[n](x, weight, bias, stride, sym, dilation, groups)
    return channels_back(out, channel_last)


@primitive
def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL"):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1,
                 data_format == "NLC")


@primitive
def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2,
                 data_format == "NHWC")


@primitive
def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW"):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3,
                 data_format == "NDHWC")


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, n, channel_last):
    stride = _norm_tuple(stride, n)
    dilation = _norm_tuple(dilation, n)
    output_padding = _norm_tuple(output_padding, n)
    x = channels_first(x, channel_last)
    k_eff = [(k - 1) * d + 1 for k, d in zip(weight.shape[2:], dilation)]
    pads = _norm_padding(padding, n)
    if isinstance(pads, str):
        if any(st != 1 for st in stride):
            raise ValueError(
                "a string padding of a transposed convolution needs stride "
                "1, as in the reference (XLA refuses it with lhs_dilation)")
        cfg = resolve_pads(pads, n, x.shape[2:], weight.shape[2:], stride,
                           dilation)
    else:
        cfg = [(k - 1 - lo, k - 1 - hi + op)
               for k, (lo, hi), op in zip(k_eff, pads, output_padding)]
    full = _CONV_T[n](x, weight, None, stride, 0, 0, groups, dilation)
    cut = [(lo - (k - 1), hi - (k - 1)) for k, (lo, hi) in zip(k_eff, cfg)]
    if any(lo or hi for lo, hi in cut):
        full = TF.pad(full, torch_pad_list(cut))
    return channels_back(_add_bias(full, bias), channel_last)


@primitive
def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCL"):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 1, data_format == "NLC")


@primitive
def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCHW"):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 2, data_format == "NHWC")


@primitive
def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCDHW"):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 3, data_format == "NDHWC")


@primitive
def deformable_conv(x, offset, weight, mask=None, bias=None, stride=1,
                    padding=0, dilation=1, deformable_groups=1, groups=1):
    raise NotImplementedError(
        "deformable_conv is not ported yet; it comes with vision/ops.py "
        "(ROADMAP.md, queue A.10)")
