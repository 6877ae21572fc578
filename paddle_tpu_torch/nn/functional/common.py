"""Common functionals (counterpart of paddle_tpu/nn/functional/common.py):
``linear``, ``embedding``, the dropouts, ``normalize``,
``cosine_similarity``, ``label_smooth``, resizing (``interpolate``,
``upsample``), the pixel and channel rearrangements, ``bilinear``,
``grid_sample``, ``affine_grid``, ``fold`` / ``unfold``,
``temporal_shift``, ``zeropad2d`` and ``sequence_mask``. Plain tensor
operations, as the reference leaves them to XLA; autograd gives the
gradients.

Resizing is ``jax.image.resize``'s, not torch's ``interpolate``:
``nearest`` samples at half-pixel centres (torch's ``nearest-exact``),
``bicubic`` is Keys' cubic with ``a = -0.5`` (torch's is -0.75), and
where an axis shrinks, ``linear`` and ``cubic`` widen their kernel by the
scale and renormalise it (antialiasing, on every axis and in every
rank). Each resized axis is one weight matrix, ``jax.image.
scale_and_translate``'s, contracted with ``torch.tensordot``. The
reference's quirks are kept: ``area`` is ``linear``, the output size is
``int(size * scale_factor)``, and ``align_corners=True`` interpolates
linearly along each axis whatever the mode but ``nearest``.

``grid_sample`` is the reference's: ``align_corners`` defaults to True,
``nearest`` rounds half to even, ``reflection`` clips after reflecting,
and the sampling runs in float32.

The dropouts draw their masks from ``generator`` (a ``torch.Generator``
on the input's device; when None, ``framework.random``'s generator for
that device, which ``paddle_tpu_torch.seed`` fixes). The draws differ
from the reference's JAX stream; the law is the same.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...core.dispatch import primitive
from ...framework import random as _random
from ...ops.manipulation import CHANNEL_LAST, _pads4, pad
from ...ops.manipulation import unfold as _unfold

_ALPHA, _SCALE = 1.6732632423543772, 1.0507009873554805


@primitive
def linear(x, weight, bias=None):
    """``x @ weight (+ bias)``, ``weight`` in Paddle's ``[in, out]``."""
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


@primitive
def embedding(x, weight, padding_idx=None, sparse=False):
    """Rows of ``weight``; rows looked up at ``padding_idx`` (negative
    counts from the end) are 0 and pass no gradient. ``sparse`` is
    accepted and unused, as in the reference."""
    out = TF.embedding(x.long(), weight)
    if padding_idx is not None:
        if padding_idx < 0:
            padding_idx += weight.shape[0]
        out = out.masked_fill((x == padding_idx).unsqueeze(-1), 0.0)
    return out


@primitive
def dropout(x, p=0.5, training=True, mode="upscale_in_train", seed=None,
            generator=None):
    """The reference's two modes. Outside training, or at ``p == 0``, it
    is the identity, except that ``downscale_in_infer`` scales by
    ``1 - p`` outside training. In training each element is kept with
    probability ``1 - p`` and, in ``upscale_in_train``, scaled by
    ``1 / (1 - p)``; dropped elements are 0.

    The mask is drawn from ``generator``, or from a new one seeded with
    ``seed``."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if seed is not None:
        generator = torch.Generator(device=x.device).manual_seed(seed)
    keep = torch.rand(x.shape, generator=_random.generator_or(
        generator, x.device), device=x.device) >= p
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
    return torch.where(keep, x, 0.0).to(x.dtype)


def _channel_dropout(x, p, training, channel_last, generator):
    """One keep/drop draw per (sample, channel), scaled by 1 / (1 - p)."""
    if not training or p == 0.0:
        return x
    shape = [1] * x.dim()
    shape[0] = x.shape[0]
    ch = x.dim() - 1 if channel_last else 1
    shape[ch] = x.shape[ch]
    keep = torch.rand(shape, generator=_random.generator_or(
        generator, x.device), device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)


@primitive
def dropout2d(x, p=0.5, training=True, data_format="NCHW", generator=None):
    return _channel_dropout(x, p, training, data_format != "NCHW",
                            generator)


@primitive
def dropout3d(x, p=0.5, training=True, data_format="NCDHW", generator=None):
    return _channel_dropout(x, p, training, data_format != "NCDHW",
                            generator)


@primitive
def alpha_dropout(x, p=0.5, training=True, generator=None):
    """SELU's dropout: a dropped element becomes ``-alpha * scale``, and
    ``a * x + b`` keeps zero mean and unit variance."""
    if not training or p == 0.0:
        return x
    alpha_p = -_ALPHA * _SCALE
    keep = torch.rand(x.shape, generator=_random.generator_or(
        generator, x.device), device=x.device) >= p
    a = 1.0 / ((1.0 - p) * (1.0 + p * alpha_p ** 2)) ** 0.5
    b = -a * alpha_p * p
    return (a * torch.where(keep, x, alpha_p) + b).to(x.dtype)


@primitive
def normalize(x, p=2.0, axis=1, epsilon=1e-12):
    norm = x.abs().pow(p).sum(dim=axis, keepdim=True).pow(1.0 / p)
    return x / norm.clamp(min=epsilon)


@primitive
def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    dot = (x1 * x2).sum(dim=axis)
    n1 = torch.linalg.vector_norm(x1, dim=axis)
    n2 = torch.linalg.vector_norm(x2, dim=axis)
    return dot / (n1 * n2).clamp(min=eps)


@primitive
def label_smooth(label, prior_dist=None, epsilon=0.1):
    if prior_dist is not None:
        return (1.0 - epsilon) * label + epsilon * prior_dist
    return (1.0 - epsilon) * label + epsilon / label.shape[-1]


# -- resizing ------------------------------------------------------------

_METHODS = {"nearest": "nearest", "bilinear": "linear", "linear": "linear",
            "trilinear": "linear", "bicubic": "cubic", "area": "linear"}


def _triangle(x):
    return (1 - x.abs()).clamp(min=0)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def _resize_weights(n_in, n_out, kernel, device):
    """``[n_in, n_out]``: ``jax.image.scale_and_translate``'s weights for
    one axis at scale ``n_out / n_in``, antialiased, in float32."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(n_out, dtype=torch.float32, device=device) + 0.5)
              * inv_scale - 0.5)
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    w = kernel((sample[None, :] - src[:, None]).abs() / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def _resize(x, axes, sizes, method):
    """``jax.image.resize(x, ..., method)`` over ``axes``; an axis whose
    size does not change is left as it is."""
    if method == "nearest":
        for axis, n in zip(axes, sizes):
            m = x.shape[axis]
            if m == n:
                continue
            pos = ((torch.arange(n, dtype=torch.float32, device=x.device)
                    + 0.5) * m / n)
            x = x.index_select(axis, torch.floor(pos).long())
        return x
    kernel = _triangle if method == "linear" else _keys_cubic
    if not x.is_floating_point():
        x = x.float()
    for axis, n in zip(axes, sizes):
        m = x.shape[axis]
        if m == n:
            continue
        w = _resize_weights(m, n, kernel, x.device).to(x.dtype)
        x = torch.tensordot(x, w, dims=([axis], [0])).movedim(-1, axis)
    return x


def _resize_align_corners(x, axes, sizes):
    """Linear along each axis with its corners on the input's."""
    out = x
    for axis, n in zip(axes, sizes):
        m = x.shape[axis]
        if m == n:
            continue
        if n == 1 or m == 1:
            out = out.index_select(axis, torch.zeros(n, dtype=torch.long,
                                                     device=x.device))
            continue
        pos = (torch.arange(n, device=x.device) * (m - 1)).float() / (n - 1)
        lo = torch.floor(pos).long()
        hi = (lo + 1).clamp(max=m - 1)
        shape = [1] * out.dim()
        shape[axis] = n
        w = (pos - lo).to(out.dtype).reshape(shape)
        out = (out.index_select(axis, lo) * (1 - w)
               + out.index_select(axis, hi) * w)
    return out


@primitive
def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, data_format="NCHW"):
    channel_last = data_format in CHANNEL_LAST
    axes = (list(range(1, x.dim() - 1)) if channel_last
            else list(range(2, x.dim())))
    spatial = [x.shape[a] for a in axes]
    if size is None:
        if isinstance(scale_factor, (int, float)):
            scale_factor = [scale_factor] * len(axes)
        size = [int(s * f) for s, f in zip(spatial, scale_factor)]
    size = [int(s) for s in (size if isinstance(size, (list, tuple))
                             else [size])]
    if len(size) != len(axes):
        raise ValueError("interpolate: %d sizes for %d spatial axes"
                         % (len(size), len(axes)))
    method = _METHODS[mode]
    if align_corners and method != "nearest":
        return _resize_align_corners(x, axes, size)
    return _resize(x, axes, size, method).to(x.dtype)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, data_format="NCHW"):
    return interpolate(x, size=size, scale_factor=scale_factor, mode=mode,
                       align_corners=align_corners, data_format=data_format)


# -- rearrangements ------------------------------------------------------

@primitive
def pixel_shuffle(x, upscale_factor, data_format="NCHW"):
    r = int(upscale_factor)
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return x.reshape(n, c // (r * r), h * r, w * r)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * r, w * r, c // (r * r))


@primitive
def pixel_unshuffle(x, downscale_factor, data_format="NCHW"):
    r = int(downscale_factor)
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
        return x.reshape(n, c * r * r, h // r, w // r)
    n, h, w, c = x.shape
    x = x.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // r, w // r, c * r * r)


def _channels_first(fn, x, data_format, *args):
    if data_format == "NHWC":
        return fn(x.permute(0, 3, 1, 2), *args).permute(0, 2, 3, 1)
    return fn(x, *args)


def _temporal_shift(x, seg_num, shift_ratio):
    nt, c, h, w = x.shape
    xr = x.reshape(nt // seg_num, seg_num, c, h, w)
    c1, c2 = int(c * shift_ratio), int(c * 2 * shift_ratio)
    back = torch.cat([xr[:, 1:, :c1], torch.zeros_like(xr[:, :1, :c1])], 1)
    fwd = torch.cat([torch.zeros_like(xr[:, :1, c1:c2]),
                     xr[:, :-1, c1:c2]], 1)
    return torch.cat([back, fwd, xr[:, :, c2:]], 2).reshape(nt, c, h, w)


@primitive
def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW"):
    """TSM's shift of ``x [N * T, C, H, W]``: the first ``shift_ratio``
    of the channels takes frame ``t + 1``'s values, the next as many
    frame ``t - 1``'s, the rest stay; zeros where no frame is."""
    return _channels_first(_temporal_shift, x, data_format, seg_num,
                           shift_ratio)


def _channel_shuffle(x, groups):
    n, c, h, w = x.shape
    return x.reshape(n, groups, c // groups, h, w).transpose(1, 2).reshape(
        n, c, h, w)


@primitive
def channel_shuffle(x, groups, data_format="NCHW"):
    return _channels_first(_channel_shuffle, x, data_format, groups)


@primitive
def bilinear(x1, x2, weight, bias=None):
    """``out[b, o] = x1[b, i] weight[o, i, j] x2[b, j] (+ bias[o])``."""
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


# -- sampling ------------------------------------------------------------

def _gs_unnormalize(coord, size, align_corners):
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


def _gs_reflect(coord, size, align_corners):
    if align_corners:
        span = size - 1
        if span == 0:
            return torch.zeros_like(coord)
        c = coord.abs() % (2 * span)
        return torch.where(c > span, 2 * span - c, c)
    c = (coord + 0.5).abs() % (2 * size)
    c = torch.where(c > size, 2 * size - c, c) - 0.5
    return c.clamp(0, size - 1)


@primitive
def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True):
    """Samples ``x [N, C, H, W]`` at ``grid [N, Hg, Wg, 2]``'s normalised
    ``(x, y)`` in [-1, 1]: ``[N, C, Hg, Wg]``; outside the input, 0
    (``zeros``), the edge (``border``) or the reflection
    (``reflection``)."""
    n, _, h, w = x.shape
    gx = _gs_unnormalize(grid[..., 0].float(), w, align_corners)
    gy = _gs_unnormalize(grid[..., 1].float(), h, align_corners)
    if padding_mode == "border":
        gx, gy = gx.clamp(0, w - 1), gy.clamp(0, h - 1)
    elif padding_mode == "reflection":
        gx = _gs_reflect(gx, w, align_corners)
        gy = _gs_reflect(gy, h, align_corners)
    xv = x.permute(0, 2, 3, 1).float()
    rows = torch.arange(n, device=x.device)[:, None, None]

    def sample(iy, ix):
        valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
        v = xv[rows, iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
        return torch.where(valid[..., None], v, 0.0)

    if mode == "nearest":
        out = sample(torch.round(gy).long(), torch.round(gx).long())
    else:
        x0, y0 = torch.floor(gx), torch.floor(gy)
        wx1, wy1 = gx - x0, gy - y0
        wx0, wy0 = 1.0 - wx1, 1.0 - wy1
        x0, y0 = x0.long(), y0.long()
        out = (sample(y0, x0) * (wy0 * wx0)[..., None]
               + sample(y0, x0 + 1) * (wy0 * wx1)[..., None]
               + sample(y0 + 1, x0) * (wy1 * wx0)[..., None]
               + sample(y0 + 1, x0 + 1) * (wy1 * wx1)[..., None])
    return out.permute(0, 3, 1, 2).to(x.dtype)


@primitive
def affine_grid(theta, out_shape, align_corners=True):
    """``theta [N, 2, 3]`` and ``out_shape (N, C, H, W)``: the sampling
    grid ``[N, H, W, 2]`` in float32."""
    theta = theta.float()
    _, _, h, w = [int(s) for s in out_shape]

    def coords(size):
        if align_corners:
            return torch.linspace(-1.0, 1.0, size, device=theta.device)
        step = 2.0 / size
        return torch.linspace(-1.0 + step / 2, 1.0 - step / 2, size,
                              device=theta.device)

    gy, gx = torch.meshgrid(coords(h), coords(w), indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    return torch.einsum("hwk,nik->nhwi", base, theta)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col of ``[N, C, H, W]``: ``[N, C * kh * kw, L]``."""
    return _unfold(x, kernel_sizes, strides, paddings, dilations)


@primitive
def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0,
         dilations=1):
    """col2im, the transpose of ``unfold``: the patches of ``x [N, C * kh
    * kw, L]`` summed into ``[N, C, *output_sizes]``, padding dropped."""
    def pair(v):
        return list(v) if isinstance(v, (list, tuple)) else [v] * 2

    oh, ow = [int(s) for s in pair(output_sizes)]
    pd = _pads4(paddings)
    out = TF.fold(x, (oh + pd[0] + pd[1], ow + pd[2] + pd[3]),
                  pair(kernel_sizes), dilation=pair(dilations),
                  stride=pair(strides))
    return out[:, :, pd[0]:pd[0] + oh, pd[2]:pd[2] + ow]


def zeropad2d(x, padding, data_format="NCHW", name=None):
    """Zeros around the spatial axes; ``padding = [left, right, top,
    bottom]``."""
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


@primitive(nondiff=True)
def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """``mask[..., j] = j < x[...]`` in ``dtype``; without ``maxlen``,
    ``max(x)`` (read back to the host, as the reference reads it)."""
    if maxlen is None:
        maxlen = int(x.max())
    pos = torch.arange(int(maxlen), device=x.device)
    mask = pos < x.unsqueeze(-1)
    return mask.to(getattr(torch, dtype) if isinstance(dtype, str)
                   else dtype)

