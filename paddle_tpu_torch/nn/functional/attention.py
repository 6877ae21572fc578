"""Attention functionals
(counterpart of paddle_tpu/nn/functional/attention.py).

``scaled_dot_product_attention`` keeps the reference's ``[B, N, H, D]``
layout and START-aligned causal convention (query i attends keys j <= i,
also when ``q_len != kv_len``). Without a mask, at a head dim the kernels
take (64, 128, 256), it goes through the flash kernel wrapper, through
``FlashAttention.apply``: the forward kernel, with the two backward
kernels as its gradient, on CUDA tensors, and their plain versions on CPU
tensors. Under ``torch.no_grad()`` (serving) it launches the forward
kernel alone. Unlike the reference's dispatch there is no tileability
gate on the lengths (the kernel masks its own ragged edges, so every
length goes to it) and no fallback on error. k/v may carry fewer heads
than q (GQA, ``H % H_kv == 0``); the kernel maps each query head onto its
kv head instead of repeating K/V. At any other head dim the head dim
alone decides (``kernels.flash_attention.head_dim_route``, before any
launch): one that the reference computes with XLA (every D outside 128Z
but 64) takes the reference's ``_sdpa_reference`` in plain ops on either
device, counted in ``plain_head_dim_calls``; a multiple of 128 from 384 on
goes to the wrapper, which raises on CUDA (ROADMAP A.3).

With ``attn_mask`` it computes the reference's XLA path
(``_sdpa_reference``) in plain tensor ops on either device: float32
scores, the start-aligned causal mask when ``is_causal``, then a boolean
mask (``where(mask, s, -1e30)``) or an additive one, a float32 softmax,
and the probabilities cast to v's dtype before the product with v. The
mask broadcasts against the ``[B, H, N, N_kv]`` scores (``[N, N_kv]``,
``[1, 1, N, N_kv]``, ``[B, 1, N, N_kv]``). Cached decode
(``models/generation.py``) takes this path after its prefill.

``dropout_p`` mirrors the reference, which accepts it and never applies
it: its XLA path (``_sdpa_reference``) takes ``dropout_p`` and computes
no dropout ("Faults of the reference" 5 in ROADMAP.md, settled as
mirrored). So a non-zero ``dropout_p`` (the Transformer layers pass their
dropout in training) changes nothing here either, and without a mask the
call still goes through the flash kernel, which computes the same
function as the reference's path.

``variable_length_attention`` is the packed-sequence entry point: the
same autograd function in its segment-id mode, at every head dim (the
reference sends it to its kernel at any D), so on CUDA a head dim outside
the kernels' raises (ROADMAP A.3).

``sparse_attention`` is the reference's: dense attention with the optional
mask, in plain ops. The reference accepts ``sparse_csr_offset`` and
``sparse_csr_columns`` and drops both ("Faults of the reference" 24 in
ROADMAP.md); here they raise.
"""
from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from ...core.dispatch import primitive
from ...kernels.flash_attention import FlashAttention, plain_head_dim

# the reference's masked score (a finite value: a row masked everywhere
# softmaxes to uniform instead of NaN)
MASKED = -1e30


@primitive
def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False, scale=None,
                                 training=True, _warn_rect_causal=True):
    """``[B, N, H, D]`` attention output; ``scale`` defaults to
    ``1/sqrt(D)``. The parameters are the reference's, in its order, so a
    positional call means the same in both packages. ``dropout_p`` and
    ``training`` are accepted and apply no attention dropout, as in the
    reference (see the module's docstring).

    ``is_causal`` with ``q_len != kv_len`` and no mask warns, as the
    reference does, that the mask is start-aligned; ``_warn_rect_causal=
    False`` silences it where that is meant (a prefill against a
    preallocated decode cache)."""
    if (is_causal and attn_mask is None and _warn_rect_causal
            and query.shape[1] != key.shape[1]):
        warnings.warn(
            "scaled_dot_product_attention: is_causal=True with "
            "q_len != kv_len uses START-aligned masking (query i "
            "attends keys j <= i). For cached decode (bottom-right "
            "alignment), pass an explicit end-aligned attn_mask.",
            stacklevel=2)
    if attn_mask is None and not plain_head_dim(query.shape[-1], query, key,
                                                 value):
        return FlashAttention.apply(query, key, value, is_causal, scale)
    return _masked_attention(query, key, value, attn_mask, is_causal, scale)


def _masked_attention(q, k, v, mask, causal, scale):
    """The reference's ``_sdpa_reference`` (with a mask, or none), in
    plain tensor ops; query head ``h`` reads kv head ``h // (H / H_kv)``,
    as the kernel maps them."""
    b, n, h, d = q.shape
    m, h_kv = k.shape[1], k.shape[2]
    if h % h_kv:
        raise ValueError("scaled_dot_product_attention: %d heads are not a "
                         "multiple of %d kv heads" % (h, h_kv))
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qg = q.float().view(b, n, h_kv, h // h_kv, d)
    logits = torch.einsum("bnkgd,bmkd->bkgnm", qg, k.float()) * scale
    logits = logits.reshape(b, h, n, m)
    if causal:
        keep = torch.ones(n, m, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, MASKED)
    if mask is not None:
        mask = torch.as_tensor(mask, device=q.device)
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, MASKED)
        else:
            logits = logits + mask.to(logits.dtype)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    probs = probs.view(b, h_kv, h // h_kv, n, m)
    out = torch.einsum("bkgnm,bmkd->bnkgd", probs, v)
    return out.reshape(b, n, h, d)


@primitive
def sparse_attention(query, key, value, sparse_csr_offset=None,
                     sparse_csr_columns=None, attn_mask=None):
    """The reference's ``sparse_attention``
    (``paddle_tpu/nn/functional/attention.py:130-136``): dense attention
    over ``[B, N, H, D]`` with the optional ``attn_mask`` (boolean or
    additive), no causal mask, in plain ops on either device. A CSR
    pattern raises ``NotImplementedError``: the reference drops it and
    computes dense attention, which is not what its caller asked for."""
    if sparse_csr_offset is not None or sparse_csr_columns is not None:
        raise NotImplementedError(
            "sparse_attention: sparse_csr_offset / sparse_csr_columns are "
            "not supported (the reference ignores them and attends densely)")
    return _masked_attention(query, key, value, attn_mask, False, None)


def segment_ids_from_lens(seq_lens, total):
    """The reference's ``seq_lens`` -> segment ids rule
    (``paddle_tpu/nn/functional/attention.py:149-166``): a 1-D list of
    lengths gives one row (shared by every batch row), a 2-D list one row
    per batch element; sequence ``i`` of a row gets id ``i``, and the
    tokens past the row's lengths form a tail with the id
    ``len(lens[row])``. Returns ``[rows, total]`` int32 numpy."""
    lens = np.asarray(seq_lens)
    if lens.ndim == 1:
        lens = lens[None]
    segs = np.zeros((lens.shape[0], total), np.int32)
    for bi in range(lens.shape[0]):
        off = 0
        for si, length in enumerate(lens[bi]):
            segs[bi, off:off + int(length)] = si
            off += int(length)
        segs[bi, off:] = lens.shape[1]
    return segs


@primitive
def variable_length_attention(query, key, value, seq_lens=None,
                              segment_ids=None, is_causal=True, scale=None):
    """Packed attention over ``[B, N, H, D]`` inputs (``N_kv == N``):
    several sequences share one row and a token attends only within its
    own sequence (and causally, by default). Give ``segment_ids [B, N]``
    or ``seq_lens`` (see ``segment_ids_from_lens``). Goes through
    ``FlashAttention`` in its segment-id mode: on CUDA tensors the
    segmented forward kernel, with the segmented dq and dk/dv kernels as
    its gradient."""
    if segment_ids is None:
        if seq_lens is None:
            raise ValueError("need seq_lens or segment_ids")
        segs = segment_ids_from_lens(seq_lens, query.shape[1])
        segment_ids = np.broadcast_to(
            segs, (query.shape[0], query.shape[1])).copy()
    return FlashAttention.apply(query, key, value, is_causal, scale,
                                segment_ids)
