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
"""
from __future__ import annotations

from ...kernels.flash_attention import FlashAttention


def scaled_dot_product_attention(query, key, value, is_causal=False,
                                 scale=None):
    """``[B, N, H, D]`` attention output; ``scale`` defaults to
    ``1/sqrt(D)``."""
    return FlashAttention.apply(query, key, value, is_causal, scale)
