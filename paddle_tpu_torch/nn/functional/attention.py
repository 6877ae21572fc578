"""Attention functionals
(counterpart of paddle_tpu/nn/functional/attention.py).

``scaled_dot_product_attention`` keeps the reference's ``[B, N, H, D]``
layout and START-aligned causal convention (query i attends keys j <= i,
also when ``q_len != kv_len``). It always goes through the flash kernel
wrapper, through ``FlashAttention.apply``: the forward kernel, with the
two backward kernels as its gradient, on CUDA tensors, and their plain
versions on CPU tensors. Under ``torch.no_grad()`` (serving) it launches
the forward kernel alone. Unlike the reference's dispatch there is
no tileability gate (the kernel masks its own ragged edges, so every
length goes to it) and no fallback on error. k/v may carry fewer heads
than q (GQA, ``H % H_kv == 0``); the kernel maps each query head onto
its kv head instead of repeating K/V.

``variable_length_attention`` is the packed-sequence entry point: the
same autograd function in its segment-id mode.
"""
from __future__ import annotations

import numpy as np

from ...kernels.flash_attention import FlashAttention


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False, scale=None,
                                 training=True):
    """``[B, N, H, D]`` attention output; ``scale`` defaults to
    ``1/sqrt(D)``. The parameters are the reference's, in its order, so a
    positional call means the same in both packages. ``attn_mask`` and
    ``dropout_p`` are not ported yet: a mask other than None or a non-zero
    ``dropout_p`` raises NotImplementedError (``training`` only matters to
    dropout)."""
    if attn_mask is not None:
        raise NotImplementedError(
            "scaled_dot_product_attention: attn_mask is not ported yet")
    if dropout_p:
        raise NotImplementedError(
            "scaled_dot_product_attention: dropout_p is not ported yet")
    return FlashAttention.apply(query, key, value, is_causal, scale)


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
