"""``pad``, ``one_hot``, ``diag_embed`` and ``unfold`` (counterpart of
paddle_tpu/ops/manipulation.py:335, 400, 440, 514): the four functions
of the reference's manipulation ops that ``nn.functional`` re-exports or
calls. Plain tensor operations, differentiable by autograd; the rest of
``ops`` is not ported yet.

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


def one_hot(x, num_classes):
    """float32 ``[..., num_classes]``; an id outside ``[0, num_classes)``
    gives a row of zeros, as ``jax.nn.one_hot`` does."""
    ids = x.long().unsqueeze(-1)
    classes = torch.arange(int(num_classes), device=x.device)
    return (ids == classes).to(torch.float32)


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


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    """im2col of ``[N, C, H, W]``: ``[N, C * kh * kw, L]``, channels
    outermost, as the reference's ``conv_general_dilated_patches``
    orders them (torch's ``unfold`` does the same; padding may be
    uneven, so it is applied first)."""
    pd = _pads4(paddings)
    x = TF.pad(x, [pd[2], pd[3], pd[0], pd[1]])
    return TF.unfold(x, _pair(kernel_sizes), dilation=_pair(dilations),
                     stride=_pair(strides))
