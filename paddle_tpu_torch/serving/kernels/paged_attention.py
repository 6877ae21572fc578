"""Paged decode attention: the CUDA kernel's wrapper and its plain version.

Counterpart of ``paddle_tpu/serving/kernels/paged_attention.py``
(float32/bfloat16 pools). Decode is one query token per slot attending
over that slot's history, scattered across fixed-size pool pages:

  q            [S, H, D]         one query token per slot
  k/v pools    [NB, bs, Hkv, D]  page pools (page 0 is the trash page)
  block_tables [S, MB] int32     page ids per slot, trash-padded
  seq_lens     [S]     int32     valid history length per slot (0 = idle)

``paged_attention`` launches ``csrc/paged_attention.cu`` for CUDA
tensors and runs ``paged_attention_reference`` for CPU tensors, and for
nothing else. The kernel emits exact zeros for idle slots; the plain
version (the reference's gather-then-dense form) emits a finite uniform
average over trash for them. Both are ignored by the engine, so
comparisons cover slots with ``len > 0`` only.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ... import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
MAX_REP_X_D = 2048      # (H / Hkv) * D: the kernel's per-thread accumulators

# kernel launches since the last reset (chip_smoke.py reads and resets it)
launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"pt_paged_attention": [_P] * 6 + [_I] * 6
               + [ctypes.c_float, _I, _P]}


def _check_shapes(q, k_pool, v_pool, block_tables, seq_lens):
    if q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError("paged_attention: q must be [S, H, D] and the pools "
                         "[NB, bs, Hkv, D]")
    s, h, d = q.shape
    if k_pool.shape[3] != d or h % k_pool.shape[2]:
        raise ValueError("paged_attention: pools %s do not fit q %s"
                         % (tuple(k_pool.shape), tuple(q.shape)))
    if (block_tables.dim() != 2 or block_tables.shape[0] != s
            or tuple(seq_lens.shape) != (s,)):
        raise ValueError("paged_attention: block_tables must be [S, MB] and "
                         "seq_lens [S]")


def paged_attention_reference(q, k_pool, v_pool, block_tables, seq_lens,
                              scale=None):
    """Plain PyTorch version: gather every slot's pages into a dense
    context, then fp32 logits, a length mask and softmax."""
    _check_shapes(q, k_pool, v_pool, block_tables, seq_lens)
    s, h, d = q.shape
    _, bs, hkv, _ = k_pool.shape
    mb = block_tables.shape[1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    bt = block_tables.long()
    k = k_pool[bt].reshape(s, mb * bs, hkv, d)
    v = v_pool[bt].reshape(s, mb * bs, hkv, d)
    if h != hkv:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    logits = torch.einsum("shd,smhd->shm", q.float(), k.float()) * scale
    valid = (torch.arange(mb * bs, device=q.device)[None, None, :]
             < seq_lens.to(q.device)[:, None, None])
    logits = logits.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("shm,smhd->shd", probs.to(v.dtype), v)


def paged_attention(q, k_pool, v_pool, block_tables, seq_lens, scale=None):
    """q ``[S, H, D]`` over the paged history -> ``[S, H, D]``.

    CUDA tensors launch the kernel (float32 or bfloat16, head_dim 64 or
    128, contiguous, int32 tables and lengths) or raise; CPU tensors take
    the plain version."""
    _check_shapes(q, k_pool, v_pool, block_tables, seq_lens)
    s, h, d = q.shape
    nb, bs, hkv, _ = k_pool.shape
    mb = block_tables.shape[1]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    tensors = (q, k_pool, v_pool, block_tables, seq_lens)
    dev = q.device
    if all(t.device.type == "cpu" for t in tensors):
        return paged_attention_reference(q, k_pool, v_pool, block_tables,
                                         seq_lens, scale)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("paged_attention: all inputs must be on one CUDA "
                         "device or all on the CPU")
    if (q.dtype not in _build.DTYPE_CODES or k_pool.dtype != q.dtype
            or v_pool.dtype != q.dtype):
        raise ValueError("paged_attention: the kernel takes float32 or "
                         "bfloat16 q and pools of one dtype, got %s/%s/%s"
                         % (q.dtype, k_pool.dtype, v_pool.dtype))
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise ValueError("paged_attention: block_tables and seq_lens must "
                         "be int32")
    if d not in HEAD_DIMS:
        raise ValueError("paged_attention: head_dim %d not in %s"
                         % (d, HEAD_DIMS))
    if (h // hkv) * d > MAX_REP_X_D:
        raise ValueError("paged_attention: (H / Hkv) * D = %d exceeds %d"
                         % ((h // hkv) * d, MAX_REP_X_D))
    if s > 65535:
        raise ValueError("paged_attention: %d slots exceed the grid limit"
                         % s)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention: inputs must be contiguous")
    out = torch.empty_like(q)
    lib = _build.load("paged_attention", _SIGNATURES)
    err = lib.pt_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        s, h, hkv, d, bs, mb, scale, _build.DTYPE_CODES[q.dtype],
        _build.stream_handle(dev))
    _build.check(lib, err, "paged_attention")
    global launches
    launches += 1
    return out
