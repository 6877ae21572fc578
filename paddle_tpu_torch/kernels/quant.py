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
scales)``. For CUDA tensors it launches ``csrc/w8_gemm.cu`` (fp32 x; the
dequantize happens in registers, so only the int8 planes and the scales
are read) or raises; for CPU tensors it runs the plain version. The
reference has no Pallas kernel here: its decode step dequantizes inside
the traced step and XLA fuses the multiply into the matmul's operand read.
``launches`` counts the kernel's launches (a plain integer, reset and read
by ``chip_smoke.py``).

``int8_weight_routes(table)`` is the context the serving engine enters
around its decode and mixed steps: inside it, every ``nn.Linear`` found in
``table`` (module -> ``(q, scales)``) computes its product through
``int8_weight_matmul`` instead of its fp32 weight.
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes

import torch

from .. import _build

# int8 symmetric range: +-127
QMAX = 127.0
DEFAULT_BLOCK = 256

# The GEMM's tiling (csrc/w8_gemm.cu): output rows and columns a CTA
# computes, the most k rows a CTA takes, the fewest a split is cut to, and
# the H100's 132 SMs (one CTA fits on an SM).
W8_TM, W8_TN = 16, 256
W8_MAX_CHUNK, W8_MIN_CHUNK = 1024, 128
W8_WAVE = 132

# kernel launches since the last reset
launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"pt_w8_gemm": [_P] * 6 + [_I] * 6 + [_P]}
# per CUDA device: the split-K tile counters the kernel leaves at zero
_counters = {}


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


def w8_plan(m, n, k):
    """``(chunk, splits)``: the k rows a CTA takes and the splits of K, from
    shapes alone. The output tiles (``W8_TM x W8_TN``) are split along K
    until the grid fills the card once, no split shorter than
    ``W8_MIN_CHUNK`` rows, and none longer than ``W8_MAX_CHUNK`` (its x
    chunk is staged in shared memory)."""
    tiles = -(-n // W8_TN) * -(-m // W8_TM)
    splits = max(-(-k // W8_MAX_CHUNK),
                 min(-(-W8_WAVE // tiles), -(-k // W8_MIN_CHUNK)))
    chunk = -(-k // splits)
    return chunk, -(-k // chunk)


def _tile_counters(device, tiles):
    buf = _counters.get(device)
    if buf is None or buf.numel() < tiles:
        buf = torch.zeros(max(tiles, 1024), dtype=torch.int32, device=device)
        _counters[device] = buf
    return buf


def int8_weight_matmul(x, q, scales):
    """``x (..., K) @ dequantize_int8_weight(q (K, N), scales (K / b, N))``
    -> ``(..., N)``.

    CUDA tensors launch ``csrc/w8_gemm.cu`` (fp32 ``x`` contiguous along
    its rows, int8 ``q`` and fp32 ``scales`` contiguous; ``b`` divides
    ``K``) or raise; CPU tensors take the plain version."""
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
    if x.dtype != torch.float32 or q.dtype != torch.int8 \
            or scales.dtype != torch.float32:
        raise ValueError("int8_weight_matmul: the kernel takes float32 x, "
                         "int8 q and float32 scales, got %s/%s/%s"
                         % (x.dtype, q.dtype, scales.dtype))
    if not (x.is_contiguous() and q.is_contiguous()
            and scales.is_contiguous()):
        raise ValueError("int8_weight_matmul: inputs must be contiguous")
    k, n = q.shape
    m = x.numel() // k
    out = torch.empty(x.shape[:-1] + (n,), dtype=torch.float32, device=dev)
    if m == 0:
        return out
    chunk, splits = w8_plan(m, n, k)
    partial = counters = None
    if splits > 1:
        partial = torch.empty(splits * m * n, dtype=torch.float32,
                              device=dev)
        counters = _tile_counters(dev, -(-n // W8_TN) * -(-m // W8_TM))
    lib = _build.load("w8_gemm", _SIGNATURES)
    err = lib.pt_w8_gemm(
        x.data_ptr(), q.data_ptr(), scales.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(),
        None if counters is None else counters.data_ptr(),
        m, n, k, k // scales.shape[0], chunk, splits,
        _build.stream_handle(dev))
    _build.check(lib, err, "int8_weight_matmul")
    global launches
    launches += 1
    return out


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
