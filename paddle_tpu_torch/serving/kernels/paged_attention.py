"""Paged attention: the CUDA kernels' wrappers and their plain versions.

Counterpart of ``paddle_tpu/serving/kernels/paged_attention.py``. The
history of every slot lives scattered across fixed-size pool pages:

  k/v pools    [NB, bs, Hkv, D]  page pools (page 0 is the trash page):
                                 float32/bfloat16/float16, or int8 beside
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

The kernels cut each slot's history into splits of pages, one CTA each,
and merge the splits' partials in a combine kernel. ``split_plan`` picks
the kernel and the split from shapes alone (no length is read from the
card, so a call never synchronises). ``*_split_reference`` compute the
same split-then-merge in PyTorch; the CPU tests hold them against the
reference, and nothing on the serving path calls them.

float16 (the reference's kernels upcast any float q and pages to fp32 and
write the output in q's dtype) takes float16 q with float16 pools or int8
pools: the kernels' math stays fp32 and only the output is rounded to
float16. The plain versions are the reference's jnp form, which also
rounds the probabilities to v's dtype before the last product; the
kernels keep them in fp32, as the reference's Pallas kernels do.

Launch counters (plain integers, reset and read by ``chip_smoke.py``),
one per kernel and pool mode: ``launches`` / ``int8_launches`` (decode),
``mixed_launches`` / ``mixed_int8_launches`` (mixed), for float32 and
bfloat16 q; float16 q counts apart, in ``f16_launches`` /
``f16_int8_launches`` and ``f16_mixed_launches`` /
``f16_mixed_int8_launches``.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ... import _build
from ...kernels import flash_attention as _fa
from ...kernels.quant import dequantize_int8_block

NEG_INF = -1e30
HEAD_DIMS = _fa.HEAD_DIMS
KV_INT8 = 2             # the C side's pool code for int8 (beside DTYPE_CODES)
GRID_LIMIT = 65535      # a CUDA grid's y and z extent

# The split plan's constants (csrc/paged_attention.cu): query rows per
# tile of the decode, short mixed and tiles kernels (64, or 128 from
# TALL_MIN_ROWS rows); the rows (H / Hkv * C a slot and kv head) from
# which the mixed step takes the tiles kernel; pages per split of the rows
# kernels, and the least pages per split of the tiles kernel; the H100's
# 132 SMs times the CTAs that fit on one (the rows kernels take ~70 KB of
# shared memory, the tiles kernel up to 224 KB).
DECODE_ROWS, MIXED_ROWS, TILE_ROWS, TALL_TILE_ROWS = 8, 16, 64, 128
TILED_MIN_ROWS, TALL_MIN_ROWS = 64, 512
SPLIT_PAGES = 16
TILE_SPLIT_PAGES = 16
ROWS_WAVE, TILES_WAVE = 3 * 132, 132
# D = 256 (csrc/paged_attention.cu's MIXED_ROWS<D>, DECODE_CTAS<D> and
# launch_mixed): 8-row mixed tiles, two decode CTAs an SM (the decode and
# mixed rows kernels alike: 2 x 132 CTA slots), 64-row tiles only
WIDE_HEAD_DIM = 256
WIDE_MIXED_ROWS, WIDE_ROWS_WAVE = 8, 2 * 132

# kernel launches since the last reset, by kernel and pool mode
launches = 0
int8_launches = 0
mixed_launches = 0
mixed_int8_launches = 0
f16_launches = 0
f16_int8_launches = 0
f16_mixed_launches = 0
f16_mixed_int8_launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "pt_paged_attention": [_P] * 9 + [_I] * 8 + [_F, _I, _I, _P],
    "pt_mixed_paged_attention": [_P] * 10 + [_I] * 10 + [_F, _I, _I, _P],
}


class SplitPlan(NamedTuple):
    kernel: str        # "decode", "rows" (short mixed step) or "tiles"
    tile_rows: int     # query rows per tile
    tiles: int         # query-row tiles per (slot, kv head)
    split_pages: int   # pages per split
    splits: int        # splits per (row tile, slot, kv head)


def split_plan(slots, chunk, heads, kv_heads, max_blocks, block_size,
               decode=False, head_dim=128):
    """The kernel and the history split for a call, from shapes alone
    (Python ints: nothing here may read a tensor on the card).
    ``head_dim`` 256 takes 8-row mixed tiles, no 128-row tiles and two
    rows-kernel CTAs an SM (``WIDE_*``).

    Decode takes the decode kernel (8-row tiles); a mixed step with fewer
    than ``TILED_MIN_ROWS`` rows a slot and kv head the rows kernel
    (16-row tiles), else the register-blocked tiles kernel (64-row tiles,
    128 from ``TALL_MIN_ROWS`` rows).
    A grid that already fills the card's CTA slots once takes one split:
    the kernel then writes the output itself and no combine runs. Else the
    rows kernels cut every history into splits of ``SPLIT_PAGES`` pages
    (one long slot no longer walks its pages alone); the tiles kernel takes
    as many splits of at least ``TILE_SPLIT_PAGES`` pages as fill the card.
    Every page of the table lies in exactly one split."""
    args = (slots, chunk, heads, kv_heads, max_blocks, block_size)
    if not all(isinstance(x, int) and not isinstance(x, bool)
               for x in args):
        raise TypeError("split_plan takes Python ints (shapes only), got %r"
                        % (args,))
    if min(args) < 1 or heads % kv_heads:
        raise ValueError("split_plan: bad shapes %r" % (args,))
    rows = heads // kv_heads * chunk
    wide = head_dim == WIDE_HEAD_DIM
    rows_wave = WIDE_ROWS_WAVE if wide else ROWS_WAVE
    if decode:
        kernel, tile_rows, wave = "decode", DECODE_ROWS, rows_wave
    elif rows >= TILED_MIN_ROWS:
        kernel, wave = "tiles", TILES_WAVE
        tile_rows = (TALL_TILE_ROWS if rows >= TALL_MIN_ROWS and not wide
                     else TILE_ROWS)
    else:
        kernel, wave = "rows", rows_wave
        tile_rows = WIDE_MIXED_ROWS if wide else MIXED_ROWS
    tiles = -(-rows // tile_rows)
    ctas = tiles * kv_heads * slots
    if ctas >= wave:
        split_pages = max_blocks
    elif kernel == "tiles":
        splits = min(-(-wave // ctas), -(-max_blocks // TILE_SPLIT_PAGES))
        split_pages = -(-max_blocks // splits)
    else:
        split_pages = min(SPLIT_PAGES, max_blocks)
    return SplitPlan(kernel, tile_rows, tiles, split_pages,
                     -(-max_blocks // split_pages))


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


def _split_merge(logits, visible, v, span, splits, eq):
    """Split-then-merge attention over the key axis (the last of
    ``logits``): each split of ``span`` keys keeps its own max ``m``, sum
    ``l`` and unnormalised output ``o`` over its visible keys (a row that
    sees none of a split keeps ``l = 0`` and weighs 0), then the splits
    merge with weights ``exp(m_i - max m)``. ``eq`` contracts p with
    ``v``; a row that sees no key at all comes out as zeros. Returns the
    output and, for the tests, the partials ``(m, l, o)``, the merge
    weights and the merged ``l``."""
    parts = []
    for i in range(splits):
        keys = slice(i * span, (i + 1) * span)
        lg, vis = logits[..., keys], visible[..., keys]
        m = lg.masked_fill(~vis, NEG_INF).amax(-1, keepdim=True)
        p = torch.exp(lg - m).masked_fill(~vis, 0.0)
        parts.append((m, p.sum(-1, keepdim=True),
                      torch.einsum(eq, p, v[:, keys])))
    m_all = torch.stack([m for m, l, _ in parts])
    l_all = torch.stack([l for _, l, _ in parts])
    m_max = m_all.masked_fill(l_all == 0, NEG_INF).amax(0)
    w = torch.exp(m_all - m_max).masked_fill(l_all == 0, 0.0)
    den = (w * l_all).sum(0)
    num = sum(wi * o for wi, (_, _, o) in zip(w, parts))
    return num / den.clamp_min(1e-30), parts, w, den


def _split_view(k_pool, v_pool, block_tables, k_scale, v_scale, s, h):
    """The dense fp32 context the split references work on: every slot's
    pages gathered, int8 pages dequantized, kv heads repeated to H."""
    _, bs, hkv, _ = k_pool.shape
    m = block_tables.shape[1] * bs
    bt = block_tables.long()
    k = _gather(k_pool, k_scale, bt, s, m).float()
    v = _gather(v_pool, v_scale, bt, s, m).float()
    if h != hkv:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    return k, v, m


def paged_attention_split_reference(q, k_pool, v_pool, block_tables,
                                    seq_lens, scale=None, k_scale=None,
                                    v_scale=None, split_pages=None):
    """Plain PyTorch version of the decode kernel's split-then-merge:
    per-split partials (O, m, l) over ``split_pages`` pages (default:
    ``split_plan``'s), then the merge. Idle slots come out as zeros, as
    from the kernel."""
    _check_shapes(q, k_pool, v_pool, block_tables, seq_lens, k_scale,
                  v_scale)
    s, h, d = q.shape
    _, bs, hkv, _ = k_pool.shape
    mb = block_tables.shape[1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    if split_pages is None:
        split_pages = split_plan(s, 1, h, hkv, mb, bs, decode=True,
                                 head_dim=d).split_pages
    k, v, m = _split_view(k_pool, v_pool, block_tables, k_scale, v_scale, s,
                          h)
    logits = torch.einsum("shd,smhd->shm", q.float(), k) * scale
    visible = (torch.arange(m, device=q.device)[None, None, :]
               < seq_lens.to(q.device)[:, None, None]).expand_as(logits)
    out = _split_merge(logits, visible, v, split_pages * bs,
                       -(-mb // split_pages), "shm,smhd->shd")[0]
    return out.to(q.dtype)


def mixed_paged_attention_split_reference(q, k_pool, v_pool, block_tables,
                                          hist_lens, q_lens, scale=None,
                                          k_scale=None, v_scale=None,
                                          split_pages=None):
    """Plain PyTorch version of the mixed kernels' split-then-merge: row
    (s, ci) sees keys ``0 .. hist + ci`` split into ``split_pages`` pages
    (default: ``split_plan``'s); a later split wholly past a row's horizon
    leaves that row ``l = 0`` and weight 0. Rows past ``q_len`` come out
    as zeros, as from the kernels."""
    _check_mixed_shapes(q, k_pool, v_pool, block_tables, hist_lens, q_lens,
                        k_scale, v_scale)
    s, c, h, d = q.shape
    _, bs, hkv, _ = k_pool.shape
    mb = block_tables.shape[1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    if split_pages is None:
        split_pages = split_plan(s, c, h, hkv, mb, bs,
                                 head_dim=d).split_pages
    k, v, m = _split_view(k_pool, v_pool, block_tables, k_scale, v_scale, s,
                          h)
    logits = torch.einsum("schd,smhd->shcm", q.float(), k) * scale
    ci = torch.arange(c, device=q.device)
    qpos = hist_lens.to(q.device).long()[:, None] + ci[None, :]   # [S, C]
    visible = ((torch.arange(m, device=q.device)[None, None, :]
                <= qpos[:, :, None])
               & (ci[None, :, None] < q_lens.to(q.device)[:, None, None]))
    visible = visible[:, None].expand_as(logits)                # [S,H,C,M]
    out = _split_merge(logits, visible, v, split_pages * bs,
                       -(-mb // split_pages), "shcm,smhd->shcd")[0]
    return out.transpose(1, 2).to(q.dtype)                 # [S, C, H, D]


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
        raise ValueError("%s: the kernel takes float32, bfloat16 or float16 "
                         "q, got %s"
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
        raise ValueError(_fa.no_kernel_message(name, d))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("%s: inputs must be contiguous" % name)
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("%s: pools must be 16-byte aligned (cp.async)"
                         % name)
    return kv_code, scale_ptrs


def _launch_plan(name, q, rows, k_pool, block_tables, decode):
    """The split plan of a CUDA launch, checked against the grid's limits,
    and its partials' scratch (one fp32 ``torch.empty``: O, then m, then
    l, for ``rows`` output rows and every split), or None for one split."""
    _, bs, hkv, d = k_pool.shape
    s, h = q.shape[0], q.shape[-2]
    plan = split_plan(s, rows // (s * h), h, hkv, block_tables.shape[1], bs,
                      decode=decode, head_dim=d)
    # the rows kernels' grid is (split, kv head, slot x tile), the tiles
    # kernel's (slot x kv head x split, tile)
    yz = ((plan.tiles,) if plan.kernel == "tiles"
          else (hkv, s * plan.tiles))
    if max(yz) > GRID_LIMIT:
        raise ValueError("%s: a grid of %s exceeds the limit %d"
                         % (name, yz, GRID_LIMIT))
    scratch = None
    if plan.splits > 1:
        scratch = torch.empty(rows * plan.splits * (d + 2),
                              dtype=torch.float32, device=q.device)
    return plan, scratch


def paged_attention(q, k_pool, v_pool, block_tables, seq_lens, scale=None,
                    k_scale=None, v_scale=None):
    """q ``[S, H, D]`` over the paged history -> ``[S, H, D]``.

    CUDA tensors launch the decode kernel, and with more than one split
    the combine (float32, bfloat16 or float16 q; pools of q's dtype, or
    int8 with float32 ``k_scale``/``v_scale``; head_dim 64, 128 or 256;
    contiguous, 16-byte aligned pools; int32 tables and lengths) or raise;
    CPU tensors take the plain version, and so does every head dim that
    ``head_dim_route`` sends there (kernels/flash_attention.py)."""
    _check_shapes(q, k_pool, v_pool, block_tables, seq_lens, k_scale,
                  v_scale)
    s, h, d = q.shape
    nb, bs, hkv, _ = k_pool.shape
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    tensors = [q, k_pool, v_pool, block_tables, seq_lens]
    if k_scale is not None:
        tensors += [k_scale, v_scale]
    if (_fa.plain_head_dim(d, *tensors)
            or all(t.device.type == "cpu" for t in tensors)):
        return paged_attention_reference(q, k_pool, v_pool, block_tables,
                                         seq_lens, scale, k_scale, v_scale)
    kv_code, (ks, vs) = _kernel_args(
        "paged_attention", q, k_pool, v_pool, k_scale, v_scale,
        (block_tables, seq_lens))
    plan, scratch = _launch_plan("paged_attention", q, s * h, k_pool,
                                 block_tables, decode=True)
    out = torch.empty_like(q)
    lib = _build.load("paged_attention", _SIGNATURES)
    err = lib.pt_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ks, vs,
        block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        s, h, hkv, d, bs, block_tables.shape[1], plan.split_pages,
        plan.splits, scale, _build.DTYPE_CODES[q.dtype], kv_code,
        _build.stream_handle(q.device))
    _build.check(lib, err, "paged_attention")
    global launches, int8_launches, f16_launches, f16_int8_launches
    if q.dtype == torch.float16:
        if k_scale is None:
            f16_launches += 1
        else:
            f16_int8_launches += 1
    elif k_scale is None:
        launches += 1
    else:
        int8_launches += 1
    return out


def mixed_paged_attention(q, k_pool, v_pool, block_tables, hist_lens,
                          q_lens, scale=None, k_scale=None, v_scale=None):
    """q ``[S, C, H, D]`` ragged rows over the paged history ->
    ``[S, C, H, D]``; rows past ``q_len`` are zeros from the kernel and
    finite from the plain version.

    CUDA tensors launch the mixed rows or tiles kernel (``split_plan``),
    and with more than one split the combine (float32, bfloat16 or float16
    q; pools of q's dtype, or int8 with float32 scales; head_dim 64, 128
    or 256; contiguous, 16-byte aligned pools; int32 tables and lengths;
    ``hist + q_len <= MB * bs``) or raise; CPU tensors take the plain
    version, and so does every head dim that ``head_dim_route`` sends
    there."""
    _check_mixed_shapes(q, k_pool, v_pool, block_tables, hist_lens, q_lens,
                        k_scale, v_scale)
    s, c, h, d = q.shape
    nb, bs, hkv, _ = k_pool.shape
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    tensors = [q, k_pool, v_pool, block_tables, hist_lens, q_lens]
    if k_scale is not None:
        tensors += [k_scale, v_scale]
    if (_fa.plain_head_dim(d, *tensors)
            or all(t.device.type == "cpu" for t in tensors)):
        return mixed_paged_attention_reference(
            q, k_pool, v_pool, block_tables, hist_lens, q_lens, scale,
            k_scale, v_scale)
    kv_code, (ks, vs) = _kernel_args(
        "mixed_paged_attention", q, k_pool, v_pool, k_scale, v_scale,
        (block_tables, hist_lens, q_lens))
    plan, scratch = _launch_plan("mixed_paged_attention", q, s * c * h,
                                 k_pool, block_tables, decode=False)
    out = torch.empty_like(q)
    lib = _build.load("paged_attention", _SIGNATURES)
    err = lib.pt_mixed_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ks, vs,
        block_tables.data_ptr(), hist_lens.data_ptr(), q_lens.data_ptr(),
        out.data_ptr(), None if scratch is None else scratch.data_ptr(),
        s, c, h, hkv, d, bs, block_tables.shape[1],
        plan.tile_rows, plan.split_pages, plan.splits, scale,
        _build.DTYPE_CODES[q.dtype], kv_code, _build.stream_handle(q.device))
    _build.check(lib, err, "mixed_paged_attention")
    global mixed_launches, mixed_int8_launches
    global f16_mixed_launches, f16_mixed_int8_launches
    if q.dtype == torch.float16:
        if k_scale is None:
            f16_mixed_launches += 1
        else:
            f16_mixed_int8_launches += 1
    elif k_scale is None:
        mixed_launches += 1
    else:
        mixed_int8_launches += 1
    return out
