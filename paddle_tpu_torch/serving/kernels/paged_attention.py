"""Paged attention: the CUDA kernels' wrappers and their plain versions.

Counterpart of ``paddle_tpu/serving/kernels/paged_attention.py``. The
history of every slot lives scattered across fixed-size pool pages:

  k/v pools    [NB, bs, Hkv, D]  page pools (page 0 is the trash page):
                                 float32/bfloat16, or int8 beside
  k/v scales   [NB, bs, Hkv]     fp32 per-vector scales (int8 pools only,
                                 ``FLAGS_serving_quant_kv``)
  block_tables [S, MB] int32     page ids per slot, trash-padded

``paged_attention`` (decode) takes one query per slot, q ``[S, H, D]``,
over ``seq_lens [S]`` history tokens (0 = idle).
``mixed_paged_attention`` (the mixed ragged step of chunked prefill and
the prefix-cache suffix prefill) takes q ``[S, C, H, D]``: row s holds
``q_lens[s]`` new tokens at positions ``hist_lens[s] ..
hist_lens[s] + q_lens[s] - 1``, whose K/V are already in the pool, and
row (s, ci) sees keys ``0 .. hist + ci``.

Each wrapper launches ``csrc/paged_attention.cu`` for CUDA tensors and
runs its ``*_reference`` plain version (the reference's gather-then-dense
form, int8 pages dequantized right after the gather) for CPU tensors, and
for nothing else. The kernels emit exact zeros for idle slots and for
mixed rows past ``q_len``; the plain versions emit finite values there.
The engine ignores both, so comparisons cover valid rows only.

Launch counters (plain integers, reset and read by ``chip_smoke.py``),
one per kernel and pool mode: ``launches`` / ``int8_launches`` (decode),
``mixed_launches`` / ``mixed_int8_launches`` (mixed).
"""
from __future__ import annotations

import ctypes
import math

import torch

from ... import _build
from ...kernels.quant import dequantize_int8_block

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
MAX_REP_X_D = 2048      # (H / Hkv) * D: the decode kernel's accumulators
KV_INT8 = 2             # the C side's pool code for int8 (beside DTYPE_CODES)

# kernel launches since the last reset, by kernel and pool mode
launches = 0
int8_launches = 0
mixed_launches = 0
mixed_int8_launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "pt_paged_attention": [_P] * 8 + [_I] * 6 + [_F, _I, _I, _P],
    "pt_mixed_paged_attention": [_P] * 9 + [_I] * 7 + [_F, _I, _I, _P],
}


def _check_pools(name, q, k_pool, v_pool, k_scale, v_scale):
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError("%s: pools must be [NB, bs, Hkv, D] of one shape"
                         % name)
    h, d = q.shape[-2:]
    if k_pool.shape[3] != d or h % k_pool.shape[2]:
        raise ValueError("%s: pools %s do not fit q %s"
                         % (name, tuple(k_pool.shape), tuple(q.shape)))
    if (k_scale is None) != (v_scale is None):
        raise ValueError("%s: pass both k_scale and v_scale or neither"
                         % name)
    if k_scale is not None and (tuple(k_scale.shape) != tuple(v_scale.shape)
                                or tuple(k_scale.shape)
                                != tuple(k_pool.shape[:3])):
        raise ValueError("%s: scales must be [NB, bs, Hkv] = %s"
                         % (name, tuple(k_pool.shape[:3])))


def _check_shapes(q, k_pool, v_pool, block_tables, seq_lens, k_scale,
                  v_scale):
    if q.dim() != 3:
        raise ValueError("paged_attention: q must be [S, H, D]")
    _check_pools("paged_attention", q, k_pool, v_pool, k_scale, v_scale)
    s = q.shape[0]
    if (block_tables.dim() != 2 or block_tables.shape[0] != s
            or tuple(seq_lens.shape) != (s,)):
        raise ValueError("paged_attention: block_tables must be [S, MB] and "
                         "seq_lens [S]")


def _check_mixed_shapes(q, k_pool, v_pool, block_tables, hist_lens, q_lens,
                        k_scale, v_scale):
    if q.dim() != 4:
        raise ValueError("mixed_paged_attention: q must be [S, C, H, D]")
    _check_pools("mixed_paged_attention", q, k_pool, v_pool, k_scale,
                 v_scale)
    s = q.shape[0]
    if (block_tables.dim() != 2 or block_tables.shape[0] != s
            or tuple(hist_lens.shape) != (s,)
            or tuple(q_lens.shape) != (s,)):
        raise ValueError("mixed_paged_attention: block_tables must be "
                         "[S, MB], hist_lens and q_lens [S]")


def _gather(pool, scales, bt, s, m):
    """A slot-major dense view ``[S, M, Hkv, D]`` of the pages named by
    ``bt``; int8 pages come out dequantized in fp32."""
    x = pool[bt].reshape(s, m, *pool.shape[2:])
    if scales is None:
        return x
    return dequantize_int8_block(x, scales[bt].reshape(s, m, -1))


def paged_attention_reference(q, k_pool, v_pool, block_tables, seq_lens,
                              scale=None, k_scale=None, v_scale=None):
    """Plain PyTorch version: gather every slot's pages into a dense
    context (int8 pages dequantized right after the gather), then fp32
    logits, a length mask and softmax."""
    _check_shapes(q, k_pool, v_pool, block_tables, seq_lens, k_scale,
                  v_scale)
    s, h, d = q.shape
    _, bs, hkv, _ = k_pool.shape
    m = block_tables.shape[1] * bs
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    bt = block_tables.long()
    k = _gather(k_pool, k_scale, bt, s, m)
    v = _gather(v_pool, v_scale, bt, s, m)
    if h != hkv:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    logits = torch.einsum("shd,smhd->shm", q.float(), k.float()) * scale
    valid = (torch.arange(m, device=q.device)[None, None, :]
             < seq_lens.to(q.device)[:, None, None])
    logits = logits.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("shm,smhd->shd", probs.to(v.dtype), v).to(q.dtype)


def mixed_paged_attention_reference(q, k_pool, v_pool, block_tables,
                                    hist_lens, q_lens, scale=None,
                                    k_scale=None, v_scale=None):
    """Plain PyTorch version of the mixed ragged step: gather each row's
    pages into a dense context (which already holds the chunk's own K/V)
    and apply the causal rule ``key position <= hist + ci``. Rows past
    ``q_len`` see at least key 0 and stay finite."""
    _check_mixed_shapes(q, k_pool, v_pool, block_tables, hist_lens, q_lens,
                        k_scale, v_scale)
    s, c, h, d = q.shape
    _, bs, hkv, _ = k_pool.shape
    m = block_tables.shape[1] * bs
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    bt = block_tables.long()
    k = _gather(k_pool, k_scale, bt, s, m)
    v = _gather(v_pool, v_scale, bt, s, m)
    if h != hkv:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    logits = torch.einsum("schd,smhd->shcm", q.float(), k.float()) * scale
    qpos = (hist_lens.to(q.device).long()[:, None]
            + torch.arange(c, device=q.device)[None, :])          # [S, C]
    valid = (torch.arange(m, device=q.device)[None, None, :]
             <= qpos[:, :, None])                                 # [S, C, M]
    logits = logits.masked_fill(~valid[:, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("shcm,smhd->schd", probs.to(v.dtype),
                        v).to(q.dtype)


def _kernel_args(name, q, k_pool, v_pool, k_scale, v_scale, ints):
    """Validate a CUDA launch (raising on what the kernel does not take)
    and return the pool code and the scale pointers. ``ints`` are the
    int32 index tensors."""
    tensors = [q, k_pool, v_pool, *ints]
    if k_scale is not None:
        tensors += [k_scale, v_scale]
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("%s: all inputs must be on one CUDA device or all "
                         "on the CPU" % name)
    if q.dtype not in _build.DTYPE_CODES:
        raise ValueError("%s: the kernel takes float32 or bfloat16 q, got %s"
                         % (name, q.dtype))
    if k_scale is None:
        if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
            raise ValueError("%s: pools must be q's dtype %s (or int8 with "
                             "scales), got %s/%s" % (name, q.dtype,
                                                     k_pool.dtype,
                                                     v_pool.dtype))
        kv_code, scale_ptrs = _build.DTYPE_CODES[q.dtype], (None, None)
    else:
        if (k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8
                or k_scale.dtype != torch.float32
                or v_scale.dtype != torch.float32):
            raise ValueError("%s: scaled pools must be int8 with float32 "
                             "scales, got %s/%s and %s/%s"
                             % (name, k_pool.dtype, v_pool.dtype,
                                k_scale.dtype, v_scale.dtype))
        kv_code = KV_INT8
        scale_ptrs = (k_scale.data_ptr(), v_scale.data_ptr())
    if any(t.dtype != torch.int32 for t in ints):
        raise ValueError("%s: block tables and lengths must be int32" % name)
    d = q.shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError("%s: head_dim %d not in %s" % (name, d, HEAD_DIMS))
    if q.shape[0] > 65535 or k_pool.shape[2] > 65535:
        raise ValueError("%s: %d slots x %d kv heads exceed the grid limit"
                         % (name, q.shape[0], k_pool.shape[2]))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("%s: inputs must be contiguous" % name)
    return kv_code, scale_ptrs


def paged_attention(q, k_pool, v_pool, block_tables, seq_lens, scale=None,
                    k_scale=None, v_scale=None):
    """q ``[S, H, D]`` over the paged history -> ``[S, H, D]``.

    CUDA tensors launch the decode kernel (float32 or bfloat16 q; pools
    of q's dtype, or int8 with float32 ``k_scale``/``v_scale``; head_dim
    64 or 128; (H / Hkv) * D <= 2048; contiguous; int32 tables and
    lengths) or raise; CPU tensors take the plain version."""
    _check_shapes(q, k_pool, v_pool, block_tables, seq_lens, k_scale,
                  v_scale)
    s, h, d = q.shape
    nb, bs, hkv, _ = k_pool.shape
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    tensors = [q, k_pool, v_pool, block_tables, seq_lens]
    if k_scale is not None:
        tensors += [k_scale, v_scale]
    if all(t.device.type == "cpu" for t in tensors):
        return paged_attention_reference(q, k_pool, v_pool, block_tables,
                                         seq_lens, scale, k_scale, v_scale)
    kv_code, (ks, vs) = _kernel_args(
        "paged_attention", q, k_pool, v_pool, k_scale, v_scale,
        (block_tables, seq_lens))
    if (h // hkv) * d > MAX_REP_X_D:
        raise ValueError("paged_attention: (H / Hkv) * D = %d exceeds %d"
                         % ((h // hkv) * d, MAX_REP_X_D))
    out = torch.empty_like(q)
    lib = _build.load("paged_attention", _SIGNATURES)
    err = lib.pt_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ks, vs,
        block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        s, h, hkv, d, bs, block_tables.shape[1], scale,
        _build.DTYPE_CODES[q.dtype], kv_code, _build.stream_handle(q.device))
    _build.check(lib, err, "paged_attention")
    global launches, int8_launches
    if k_scale is None:
        launches += 1
    else:
        int8_launches += 1
    return out


def mixed_paged_attention(q, k_pool, v_pool, block_tables, hist_lens,
                          q_lens, scale=None, k_scale=None, v_scale=None):
    """q ``[S, C, H, D]`` ragged rows over the paged history ->
    ``[S, C, H, D]``; rows past ``q_len`` are zeros from the kernel and
    finite from the plain version.

    CUDA tensors launch the mixed kernel (float32 or bfloat16 q; pools of
    q's dtype, or int8 with float32 scales; head_dim 64 or 128;
    contiguous; int32 tables and lengths; ``hist + q_len <= MB * bs``) or
    raise; CPU tensors take the plain version."""
    _check_mixed_shapes(q, k_pool, v_pool, block_tables, hist_lens, q_lens,
                        k_scale, v_scale)
    s, c, h, d = q.shape
    nb, bs, hkv, _ = k_pool.shape
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    tensors = [q, k_pool, v_pool, block_tables, hist_lens, q_lens]
    if k_scale is not None:
        tensors += [k_scale, v_scale]
    if all(t.device.type == "cpu" for t in tensors):
        return mixed_paged_attention_reference(
            q, k_pool, v_pool, block_tables, hist_lens, q_lens, scale,
            k_scale, v_scale)
    kv_code, (ks, vs) = _kernel_args(
        "mixed_paged_attention", q, k_pool, v_pool, k_scale, v_scale,
        (block_tables, hist_lens, q_lens))
    out = torch.empty_like(q)
    lib = _build.load("paged_attention", _SIGNATURES)
    err = lib.pt_mixed_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ks, vs,
        block_tables.data_ptr(), hist_lens.data_ptr(), q_lens.data_ptr(),
        out.data_ptr(), s, c, h, hkv, d, bs, block_tables.shape[1], scale,
        _build.DTYPE_CODES[q.dtype], kv_code, _build.stream_handle(q.device))
    _build.check(lib, err, "mixed_paged_attention")
    global mixed_launches, mixed_int8_launches
    if k_scale is None:
        mixed_launches += 1
    else:
        mixed_int8_launches += 1
    return out
