"""Block-scaled int8 codecs and the weight-only int8 GEMM (the port's copy
of paddle_tpu/kernels/quant.py, with the kernel the reference leaves to
XLA fusion).

Two codecs, both symmetric round-to-nearest-even into +-127 (never -128,
so negation round-trips), both with the reference's two special cases:
an all-zero group gets scale 1.0, so it dequantizes to exact zeros; a
group holding any non-finite value gets scale NaN, so the poison stays
visible after dequantization instead of being clipped finite.

- **KV pages** (``FLAGS_serving_quant_kv``): one fp32 scale per head_dim
  vector, i.e. per (page, position, kv head): the pool planes are
  ``[NB, bs, Hkv, D]`` int8 beside ``[NB, bs, Hkv]`` fp32 scales. The
  write path quantizes in the view; the attention kernels dequantize
  while staging a page (``csrc/paged_attention.cu``).
- **Projection weights** (``FLAGS_serving_quant_weights``): a 2-D
  ``[in, out]`` weight is cut into blocks of ``b = weight_block(in)`` rows
  along its input (reduction) axis, one fp32 scale per (block, column):
  ``q [in, out]`` int8 beside ``scales [in / b, out]``. The codec divides
  in fp32 and rounds half to even as the reference does, so both give the
  same int8 planes and the same scales bit for bit.

``int8_weight_matmul(x, q, scales)`` is ``x @ dequantize_int8_weight(q,
scales, x.dtype)`` in ``x``'s dtype, float32, bfloat16 or float16. For
CUDA tensors it launches ``csrc/w8_gemm.cu`` (each int8 element is
dequantized once a CTA, so only the int8 planes and the scales are read
from device memory)
with the tiles and K splits that its plan picks from the shapes, or
raises; for CPU tensors it runs the plain version. A float32 ``x`` runs
the kernel's fp32 mode (``pt_w8_gemm``, CUDA cores, planned by
``w8_plan``); a bfloat16 ``x`` its bf16 mode (``pt_w8_gemm_bf16``, the
tensor cores: ``mma.sync`` at M <= 32, ``wgmma`` above; planned by
``w8_plan_bf16``), the reference's numerics for a bf16 model: each
weight rounded to bf16 once, the products summed in fp32, the output
rounded to bf16 once; a float16 ``x`` its float16 mode
(``pt_w8_gemm_f16``: the bf16 mode's kernels and plan with float16
operands, ``mma.sync`` / ``wgmma`` ``.f32.f16.f16``), the same numerics in
float16, which is what the reference's weight-only decode of a float16
model computes. The reference has no Pallas kernel here: its
decode step dequantizes inside the traced step (to the weight's dtype)
and XLA fuses the multiply into the matmul's operand read. ``launches``
counts the kernel's launches in every mode, ``bf16_launches`` and
``f16_launches`` those of the bf16 and float16 modes (plain integers,
reset and read by ``chip_smoke.py``).

``int8_weight_routes(table)`` is the context the serving engine enters
around its decode and mixed steps: inside it, every ``nn.Linear`` found in
``table`` (module -> ``(q, scales)``) computes its product through
``int8_weight_matmul`` instead of its fp32 weight.
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes
import functools

import torch

from .. import _build

# int8 symmetric range: +-127
QMAX = 127.0
DEFAULT_BLOCK = 256

# The GEMM's plan (csrc/w8_gemm.cu). Small M (at most W8_SMALL_M rows):
# 16-row x 128-column CTAs whose K chunk is a multiple of W8_SMALL_KT rows
# (12 warps x 8). Larger M: bm-row CTAs (W8_LARGE_BM) of W8_LARGE_BN
# columns, K chunks of W8_KT-row stages. At most W8_MAX_CLUSTER splits of K
# a tile (one cluster), none below W8_MIN_CHUNK rows.
W8_SMALL_M, W8_SMALL_BM, W8_SMALL_BN, W8_SMALL_WARPS = 32, 16, 128, 12
W8_SMALL_KT = W8_SMALL_WARPS * 8
W8_LARGE_BM, W8_LARGE_BN, W8_KT = (64, 128), 128, 32
W8_MAX_CLUSTER, W8_MIN_CHUNK = 16, 128
# The SMs that clusters of c CTAs (index c - 1) fill at once, one CTA an
# SM, on an H100 SXM (w8_cluster_ctas, printed by tools/w8_timing.py
# --clusters): the GPCs' sizes leave some SMs out of clusters larger than 2.
W8_CLUSTER_SMS = (132, 132, 117, 120, 110, 102, 105, 120,
                  81, 70, 77, 84, 91, 98, 105, 112)
# a CTA's ramp (first loads, the reductions) in k rows of its own work, by
# regime, and the cost of a 64-row tile's FMA against a 128-row one's, in
# eighths: tuned against the split counts tools/w8_timing.py --sweep times
W8_SMALL_RAMP, W8_LARGE_RAMP, W8_BM64_COST = 160, 32, 10

# The bf16 mode's plan (csrc/w8_gemm.cu): bm-row x W8B_BN-column CTAs,
# bm = 16 at M <= 16 and 32 at M <= 32 (namespace tc: mma.sync, 4 warps),
# else 64 or 128 (namespace wg: wgmma on y^T = w^T x^T, 2 warpgroups); K
# chunks of W8B_KT-row stages, at most W8_MAX_CLUSTER splits, none below
# W8_MIN_CHUNK rows.
W8B_BM, W8B_BN, W8B_KT = (16, 32, 64, 128), 128, 64
# The CTAs that its kernel for bm runs at once when its clusters hold c
# CTAs (index c - 1), on an H100 SXM (w8_cluster_ctas(bm, c, bf16=True),
# printed by tools/w8_timing.py --bfloat16 --clusters).
_W8B_MMA = (528, 528, 489, 496, 470, 474, 483, 496,
            459, 440, 407, 444, 390, 420, 420, 448)       # 4 CTAs an SM
W8B_CLUSTER_CTAS = {16: _W8B_MMA, 32: _W8B_MMA,
                    64: (264, 264, 237, 248, 235, 234, 224, 240, 207, 210,
                         176, 192, 182, 196, 210, 224),   # 2 an SM
                    128: W8_CLUSTER_SMS}                  # 1 an SM
# By bm: the resident CTAs that split an SM's throughput (the bm = 64
# kernel's two share its tensor cores, the mma.sync kernel's four overlap
# in pairs, bm = 128 runs one an SM), and the cost of a k row of a CTA in
# eighths; a CTA's ramp in k rows of its own work: fitted to the split
# counts tools/w8_timing.py --bfloat16 --sweep times.
W8B_SHARE = {16: 2, 32: 2, 64: 2, 128: 1}
W8B_ROW_COST = {16: 8, 32: 9, 64: 6, 128: 8}
W8B_RAMP = 256

# kernel launches since the last reset: every mode, the bf16 mode and the
# float16 mode
launches = 0
bf16_launches = 0
f16_launches = 0
# the loaded csrc/w8_gemm.cu, once built
_lib = None

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"pt_w8_gemm": [_P] * 4 + [_I] * 7 + [_P],
               "pt_w8_gemm_bf16": [_P] * 4 + [_I] * 7 + [_P],
               "pt_w8_gemm_f16": [_P] * 4 + [_I] * 7 + [_P],
               "pt_w8_cluster_ctas": [_I] * 3 + [_P],
               "pt_w8_bf16_cluster_ctas": [_I] * 3 + [_P]}
# the C entry point of each activation dtype
_ENTRY = {torch.float32: "pt_w8_gemm", torch.bfloat16: "pt_w8_gemm_bf16",
          torch.float16: "pt_w8_gemm_f16"}


def _group_scales(amax):
    finite = torch.isfinite(amax)
    return torch.where(finite & (amax > 0), amax / QMAX,
                       torch.where(finite, torch.ones_like(amax),
                                   torch.full_like(amax, float("nan"))))


def page_scales(x):
    """Per-vector fp32 scales over the last axis of ``x``: ``max|v| /
    127``, 1.0 for an all-zero vector, NaN for one with a non-finite
    value."""
    return _group_scales(x.float().abs().amax(dim=-1))


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
    ported: ``scales.shape`` must be ``q.shape[:-1]`` (the weight codec
    has its own inverse, ``dequantize_int8_weight``)."""
    if tuple(scales.shape) != tuple(q.shape[:-1]):
        raise ValueError("dequantize_int8_block: scales %s must be q's "
                         "shape %s without its last axis"
                         % (tuple(scales.shape), tuple(q.shape)))
    return (q.float() * scales.float()[..., None]).to(dtype)


def block_scales(x, block=DEFAULT_BLOCK):
    """Per-block fp32 scales of a ``(rows, cols)`` float array, ``cols``
    a multiple of ``block``: ``(rows, cols // block)``, with
    ``page_scales``' rules for zero and non-finite blocks."""
    rows, cols = x.shape
    if cols % block:
        raise ValueError("block_scales: cols (%d) %% block (%d) != 0"
                         % (cols, block))
    xb = x.float().reshape(rows, cols // block, block)
    return _group_scales(xb.abs().amax(dim=-1))


def quantize_int8_block(x, block=DEFAULT_BLOCK):
    """``(rows, cols)`` float -> ``(q int8 (rows, cols), scales f32 (rows,
    cols // block))``, rounding half to even. (The reference's stochastic
    rounding serves gradient compression, which the port does not have.)"""
    rows, cols = x.shape
    scales = block_scales(x, block)
    v = x.float() / scales.repeat_interleave(block, dim=-1)
    q = torch.clamp(torch.round(v), -QMAX, QMAX).to(torch.int8)
    return q, scales


def weight_block(in_features, block=DEFAULT_BLOCK):
    """Largest power-of-two block <= ``block`` dividing ``in_features``
    (weight-only decode quant); falls back to one scale per column."""
    b = block
    while b >= 8:
        if in_features % b == 0:
            return b
        b //= 2
    return in_features


def quantize_int8_weight(w, block=DEFAULT_BLOCK):
    """Quantize a 2-D ``(in, out)`` projection weight block-scaled along
    the input axis: ``(q int8 (in, out), scales f32 (in // b, out))`` with
    ``b = weight_block(in, block)``. Computed in the ``[in, out]`` layout
    directly: the same elementwise fp32 division and rounding as the
    reference's transpose-then-``quantize_int8_block``, so the same bits."""
    i, o = w.shape
    b = weight_block(i, block)
    wb = w.float().reshape(i // b, b, o)
    scales = _group_scales(wb.abs().amax(dim=1))
    v = wb / scales[:, None, :]
    q = torch.clamp(torch.round(v), -QMAX, QMAX).to(torch.int8)
    return q.reshape(i, o), scales


def dequantize_int8_weight(q, scales, dtype=torch.float32):
    """Inverse of ``quantize_int8_weight``: ``q (in, out)`` int8 times
    ``scales (in // b, out)`` broadcast over each block's rows, in fp32
    (one rounding), cast to ``dtype``."""
    i, o = q.shape
    b = i // scales.shape[0]
    s = scales.float()[:, None, :].expand(scales.shape[0], b, o)
    return (q.float() * s.reshape(i, o)).to(dtype)


def int8_weight_matmul_reference(x, q, scales):
    """The plain version: ``x @ dequantize_int8_weight(q, scales)`` in
    ``x``'s dtype (the reference dequantizes to the weight's dtype and
    multiplies at 'highest' precision; the port keeps TF32 off)."""
    return torch.matmul(x, dequantize_int8_weight(q, scales, x.dtype))


@functools.lru_cache(maxsize=None)
def w8_plan(m, n, k):
    """``(bm, chunk, splits)`` from the shapes alone, integers only: the
    rows a CTA computes (``W8_SMALL_BM`` in the small-M regime, cluster
    split-K over registers; else 64 or 128, the register-tiled GEMM), and K
    cut into ``splits`` chunks of ``chunk`` rows (a multiple of the
    regime's granule). The ``splits`` CTAs of one output tile form a
    cluster, so ``splits <= W8_MAX_CLUSTER``.

    Each candidate is costed as the busiest SM's work: clusters of
    ``splits`` CTAs fill ``W8_CLUSTER_SMS[splits - 1]`` SMs at once, so a
    grid of ``ctas`` takes ``ceil(ctas / that)`` rounds, each a CTA's rows
    x columns x (chunk + the regime's ramp) of FMAs; the cheapest wins, the
    fewest splits on a tie."""
    if m <= W8_SMALL_M:
        shapes = [(W8_SMALL_BM, W8_SMALL_BN, W8_SMALL_KT, W8_SMALL_RAMP, 8)]
    else:
        low, high = W8_LARGE_BM
        shapes = [(low, W8_LARGE_BN, W8_KT, W8_LARGE_RAMP, W8_BM64_COST)]
        if m > low:
            shapes.append((high, W8_LARGE_BN, W8_KT, W8_LARGE_RAMP, 8))
    best = None
    for bm, bn, granule, ramp, eighths in shapes:
        tiles = -(-n // bn) * -(-m // bm)
        for splits in range(1, W8_MAX_CLUSTER + 1):
            chunk = -(-k // (splits * granule)) * granule
            if -(-k // chunk) != splits:
                continue             # fewer non-empty splits: seen already
            if splits > 1 and chunk < W8_MIN_CHUNK:
                break
            rounds = -(-tiles * splits // W8_CLUSTER_SMS[splits - 1])
            cost = rounds * bm * bn * (chunk + ramp) * eighths
            if best is None or cost < best[0]:
                best = (cost, bm, chunk, splits)
    return best[1:]


@functools.lru_cache(maxsize=None)
def w8_plan_bf16(m, n, k):
    """The bf16 mode's ``(bm, chunk, splits)`` from the shapes alone,
    integers only: ``bm`` rows a CTA of the tensor-core kernel (16 at
    M <= 16, 32 at M <= 32, else 64 or 128) and K cut into ``splits``
    chunks of ``chunk`` rows (a multiple of ``W8B_KT``), the ``splits``
    CTAs of an output tile one cluster.

    Each candidate is costed as the busiest SM's work: clusters of
    ``splits`` CTAs run ``W8B_CLUSTER_CTAS[bm][splits - 1]`` CTAs at once,
    ``W8B_SHARE[bm]`` of them to an SM's throughput, so the busiest of those
    lanes takes ``ceil(ctas / lanes)`` CTAs, each its chunk and the ramp at
    the cost of a k row of its bm. The cheapest wins, the fewest splits
    (then the smaller bm) on a tie."""
    if m <= 16:
        bms = (16,)
    elif m <= 32:
        bms = (32,)
    else:
        bms = (64, 128) if m > 64 else (64,)
    best = None
    for bm in bms:
        tiles = -(-n // W8B_BN) * -(-m // bm)
        for splits in range(1, W8_MAX_CLUSTER + 1):
            chunk = -(-k // (splits * W8B_KT)) * W8B_KT
            if -(-k // chunk) != splits:
                continue             # fewer non-empty splits: seen already
            if splits > 1 and chunk < W8_MIN_CHUNK:
                break
            lanes = W8B_CLUSTER_CTAS[bm][splits - 1] // W8B_SHARE[bm]
            cost = (-(-tiles * splits // lanes) * (chunk + W8B_RAMP)
                    * W8B_ROW_COST[bm])
            if best is None or cost < best[0]:
                best = (cost, bm, chunk, splits)
    return best[1:]


def _library():
    global _lib
    if _lib is None:
        _lib = _build.load("w8_gemm", _SIGNATURES)
    return _lib


def int8_weight_matmul(x, q, scales):
    """``x (..., K) @ dequantize_int8_weight(q (K, N), scales (K / b, N),
    x.dtype)`` -> ``(..., N)`` in ``x``'s dtype.

    CUDA tensors launch ``csrc/w8_gemm.cu`` (float32, bfloat16 or float16
    ``x``, contiguous; int8 ``q`` and fp32 ``scales`` contiguous; ``b`` divides
    ``K``) in the mode of ``x``'s dtype, or raise; CPU tensors take the
    plain version."""
    if q.dim() != 2 or scales.dim() != 2 or x.shape[-1] != q.shape[0] \
            or scales.shape[1] != q.shape[1] or scales.shape[0] < 1 \
            or q.shape[0] % scales.shape[0]:
        raise ValueError("int8_weight_matmul: x %s, q %s and scales %s do "
                         "not fit" % (tuple(x.shape), tuple(q.shape),
                                      tuple(scales.shape)))
    dev = x.device
    if dev.type == "cpu" and q.device == dev and scales.device == dev:
        return int8_weight_matmul_reference(x, q, scales)
    if dev.type != "cuda" or q.device != dev or scales.device != dev:
        raise ValueError("int8_weight_matmul: all inputs must be on one "
                         "CUDA device or all on the CPU")
    if x.dtype not in _ENTRY or q.dtype != torch.int8 \
            or scales.dtype != torch.float32:
        raise ValueError("int8_weight_matmul: the kernel takes float32, "
                         "bfloat16 or float16 x, int8 q and float32 "
                         "scales, got %s/%s/%s"
                         % (x.dtype, q.dtype, scales.dtype))
    if not (x.is_contiguous() and q.is_contiguous()
            and scales.is_contiguous()):
        raise ValueError("int8_weight_matmul: inputs must be contiguous")
    k, n = q.shape
    m = x.numel() // k
    out = torch.empty(x.shape[:-1] + (n,), dtype=x.dtype, device=dev)
    if m == 0:
        return out
    # both 16-bit modes run the tensor-core kernels on the bf16 mode's plan
    tc = x.dtype != torch.float32
    bm, chunk, splits = (w8_plan_bf16 if tc else w8_plan)(m, n, k)
    lib = _library()
    err = getattr(lib, _ENTRY[x.dtype])(
        x.data_ptr(), q.data_ptr(), scales.data_ptr(), out.data_ptr(),
        m, n, k, k // scales.shape[0], bm, chunk, splits,
        _build.stream_handle(dev))
    _build.check(lib, err, "int8_weight_matmul")
    global launches, bf16_launches, f16_launches
    launches += 1
    if x.dtype == torch.bfloat16:
        bf16_launches += 1
    elif x.dtype == torch.float16:
        f16_launches += 1
    return out


def w8_cluster_ctas(bm, splits, vec=True, bf16=False):
    """The CTAs the card runs at once of a grid of the kernel for ``bm``
    whose clusters hold ``splits`` CTAs (``cudaOccupancyMaxActiveClusters``
    x splits, on the current CUDA device): what ``W8_CLUSTER_SMS`` records
    for an H100 SXM, or with ``bf16`` the bf16 mode's ``W8B_CLUSTER_CTAS``."""
    lib = _library()
    out = ctypes.c_int(0)
    fn = lib.pt_w8_bf16_cluster_ctas if bf16 else lib.pt_w8_cluster_ctas
    _build.check(lib, fn(bm, splits, int(vec), ctypes.byref(out)),
                 "w8_cluster_ctas")
    return out.value


_ROUTES = contextvars.ContextVar("int8_weight_routes", default=None)


@contextlib.contextmanager
def int8_weight_routes(table):
    """Inside the block, each ``nn.Linear`` in ``table`` (module ->
    ``(q, scales)``) multiplies through ``int8_weight_matmul``."""
    token = _ROUTES.set(table)
    try:
        yield
    finally:
        _ROUTES.reset(token)


def routed_int8_weight(module):
    """``(q, scales)`` for ``module`` inside ``int8_weight_routes``, else
    None."""
    table = _ROUTES.get()
    return None if table is None else table.get(module)
