"""Flash attention forward: the CUDA kernel's wrapper and its plain version.

Counterpart of ``paddle_tpu/kernels/flash_attention.py``: blocked
online-softmax attention over ``[B, N, H, D]`` inputs with the
reference's START-aligned causal convention (query i attends keys
j <= i, for any kv length), returning the output and the per-row
log-sum-exp ``[B*H, N]`` float32 that a backward pass needs.

``flash_attention`` launches ``csrc/flash_attention.cu`` for CUDA
tensors and runs ``flash_attention_reference`` (the reference's
``_reference_attention`` form) for CPU tensors, and for nothing else:
there is no fallback from the card to the plain version. The kernel
reads q/k/v through their strides (last axis contiguous), masks ragged
lengths itself, and maps GQA query heads onto their kv head, so the
caller never folds, pads or repeats.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 128)

# kernel launches since the last reset (chip_smoke.py reads and resets it)
launches = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"pt_flash_attention_fwd": [_P] * 5 + [_I] * 6 + [_L] * 9
               + [ctypes.c_float, _I, _I, _P]}


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [B, N, H, D]")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError("flash_attention: k/v shape %s does not fit q %s"
                         % (tuple(k.shape), tuple(q.shape)))
    if h % k.shape[2]:
        raise ValueError("flash_attention: %d heads are not a multiple of "
                         "%d kv heads" % (h, k.shape[2]))


def flash_attention_reference(q, k, v, causal=False, scale=None):
    """Plain PyTorch version: fp32 logits and softmax over the whole
    score matrix, same mask and output dtype as the kernel. Returns
    ``(out [B, N, H, D], lse [B*H, N] float32)``."""
    _check_shapes(q, k, v)
    b, n, h, d = q.shape
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    if k.shape[2] != h:
        k = k.repeat_interleave(h // k.shape[2], dim=2)
        v = v.repeat_interleave(h // v.shape[2], dim=2)
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    if causal:
        keep = torch.ones(n, k.shape[1], dtype=torch.bool,
                          device=q.device).tril()
        logits = logits.masked_fill(~keep, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", probs.to(v.dtype), v)
    return out, lse.reshape(b * h, n)


def flash_attention(q, k, v, causal=False, scale=None):
    """q ``[B, N, H, D]``, k/v ``[B, N_kv, H_kv, D]`` (``H % H_kv == 0``)
    -> ``(out [B, N, H, D], lse [B*H, N] float32)``.

    CUDA tensors launch the kernel (float32 or bfloat16, head_dim 64 or
    128, last axis contiguous) or raise; CPU tensors take the plain
    version."""
    _check_shapes(q, k, v)
    b, n, h, d = q.shape
    n_kv, h_kv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    dev = q.device
    if dev.type == "cpu" and k.device == dev and v.device == dev:
        return flash_attention_reference(q, k, v, causal, scale)
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("flash_attention: q, k, v must all be on one CUDA "
                         "device or all on the CPU (got %s, %s, %s)"
                         % (q.device, k.device, v.device))
    if (q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype
            or v.dtype != q.dtype):
        raise ValueError("flash_attention: the kernel takes float32 or "
                         "bfloat16 q/k/v of one dtype, got %s/%s/%s"
                         % (q.dtype, k.dtype, v.dtype))
    if d not in HEAD_DIMS:
        raise ValueError("flash_attention: head_dim %d not in %s"
                         % (d, HEAD_DIMS))
    if n == 0 or n_kv == 0:
        raise ValueError("flash_attention: empty sequence")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention: the head_dim axis must be "
                         "contiguous")
    if b * h > 65535:
        raise ValueError("flash_attention: B*H = %d exceeds the grid limit"
                         % (b * h))
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b * h, n), dtype=torch.float32, device=dev)
    lib = _build.load("flash_attention", _SIGNATURES)
    err = lib.pt_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, n, n_kv, h, h_kv, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        scale, int(bool(causal)), _build.DTYPE_CODES[q.dtype],
        _build.stream_handle(dev))
    _build.check(lib, err, "flash_attention")
    global launches
    launches += 1
    return out, lse
