"""Int8 KV-page codec (the port's copy of the page half of
paddle_tpu/kernels/quant.py).

Serving's int8 KV pages (``FLAGS_serving_quant_kv``) keep one fp32 scale
per head_dim vector, i.e. per (page, position, kv head): the pool planes
are ``[NB, bs, Hkv, D]`` int8 beside ``[NB, bs, Hkv]`` fp32 scales.
Symmetric round-to-nearest-even into +-127 (never -128, so negation
round-trips), with the reference's two special cases:

- an all-zero vector gets scale 1.0, so it dequantizes to exact zeros;
- a vector holding any non-finite value gets scale NaN, so the poison
  stays visible after dequantization instead of being clipped finite.

These are plain PyTorch ops, as the reference's are jnp ops: the write
path quantizes in the view, and the attention kernels dequantize while
staging a page (``csrc/paged_attention.cu``). The weight codec of
weight-only int8 decode is not ported yet.
"""
from __future__ import annotations

import torch

# int8 symmetric range: +-127
QMAX = 127.0


def page_scales(x):
    """Per-vector fp32 scales over the last axis of ``x``: ``max|v| /
    127``, 1.0 for an all-zero vector, NaN for one with a non-finite
    value."""
    amax = x.float().abs().amax(dim=-1)
    finite = torch.isfinite(amax)
    one = torch.ones_like(amax)
    return torch.where(finite & (amax > 0), amax / QMAX,
                       torch.where(finite, one, torch.full_like(amax,
                                                                float("nan"))))


def quantize_int8_page(x):
    """``x (..., vec)`` float -> ``(q int8 (..., vec), scales f32
    (...))``, rounding half to even (``torch.round`` does, as
    ``jnp.round`` does)."""
    scales = page_scales(x)
    v = x.float() / scales[..., None]
    q = torch.clamp(torch.round(v), -QMAX, QMAX).to(torch.int8)
    return q, scales


def dequantize_int8_block(q, scales, dtype=torch.float32):
    """Inverse of ``quantize_int8_page``: int8 ``q (..., vec)`` times the
    per-vector ``scales (...)`` in fp32 (one rounding), cast to
    ``dtype``. Only this axis-aware form of the reference's function is
    ported: ``scales.shape`` must be ``q.shape[:-1]``."""
    if tuple(scales.shape) != tuple(q.shape[:-1]):
        raise ValueError("dequantize_int8_block: scales %s must be q's "
                         "shape %s without its last axis"
                         % (tuple(scales.shape), tuple(q.shape)))
    return (q.float() * scales.float()[..., None]).to(dtype)
