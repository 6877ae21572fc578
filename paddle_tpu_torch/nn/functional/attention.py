"""Attention functionals
(counterpart of paddle_tpu/nn/functional/attention.py).

``scaled_dot_product_attention`` keeps the reference's ``[B, N, H, D]``
layout and START-aligned causal convention (query i attends keys j <= i,
also when ``q_len != kv_len``). It always goes through the flash kernel
wrapper, which launches the CUDA kernel for CUDA tensors and runs its
plain version for CPU tensors. Unlike the reference's dispatch there is
no tileability gate (the kernel masks its own ragged edges, so every
length goes to it) and no fallback on error. k/v may carry fewer heads
than q (GQA, ``H % H_kv == 0``); the kernel maps each query head onto
its kv head instead of repeating K/V.
"""
from __future__ import annotations

from ...kernels.flash_attention import flash_attention


def scaled_dot_product_attention(query, key, value, is_causal=False,
                                 scale=None):
    """``[B, N, H, D]`` attention output; ``scale`` defaults to
    ``1/sqrt(D)``."""
    out, _ = flash_attention(query, key, value, causal=is_causal,
                             scale=scale)
    return out
