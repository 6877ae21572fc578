"""Flash attention forward and backward: the CUDA kernels' wrappers, their
plain versions, and the autograd function that joins them.

Counterpart of ``paddle_tpu/kernels/flash_attention.py``: blocked
online-softmax attention over ``[B, N, H, D]`` inputs with the
reference's START-aligned causal convention (query i attends keys
j <= i, for any kv length), returning the output and the per-row
log-sum-exp ``[B*H, N]`` float32 that the backward pass needs.

``flash_attention`` launches ``csrc/flash_attention.cu`` and
``flash_attention_backward`` launches the two kernels of
``csrc/flash_attention_bwd.cu`` (dq, then dk/dv) for CUDA tensors; for
CPU tensors they run ``flash_attention_reference`` and
``flash_attention_backward_reference`` (the reference's
``_reference_attention`` form and its ``_dq_kernel``/``_dkv_kernel``
formulas over the whole score matrix), and for nothing else: there is no
fallback from the card to the plain versions. The kernels read q/k/v/dO
through their strides (last axis contiguous), mask ragged lengths
themselves, and map GQA query heads onto their kv head, so the caller
never folds, pads or repeats; dk/dv come back for the kv heads, summed
over each group's query heads (what the reference's repeat_interleave
VJP gives). The bf16 and float16 kernels (forward, dq and dk/dv, on
``wgmma``; float16 is the same kernels with ``f16`` operands, the
reference's float16 mode) load their tiles with TMA, which needs 16-byte aligned addresses and strides:
an operand that breaks that is copied first and counted in
``tma_copies`` (the kernels are the only route; the copy is the remedy,
never a fallback). The float32 kernels run on the CUDA cores and read
any stride. ``FlashAttention`` is the ``torch.autograd.Function`` whose
forward is ``flash_attention`` and whose backward is
``flash_attention_backward``.

Segment ids (packed, variable-length sequences; the reference's
``segment_ids`` mode, ``:442-490``): every function takes an optional
``segment_ids [B, N]`` (``q_len == kv_len``), shared by the heads of a
batch row. A query sees a key only if their ids are equal, on top of the
causal mask; the ids need be neither sorted nor contiguous. Masked
scores take the reference's finite ``NEG_INF``, so a key tile that is
masked for a whole row is erased by the next visible tile's rescale
instead of turning into NaN. The kernels read the ids through one
``int32`` pointer (``nullptr`` = off) and skip every (query tile, key
tile) pair whose id intervals do not meet; the segmented launches have
counters of their own.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build

NEG_INF = -1e30
# the head dims the kernels take (flash here, paged in
# serving/kernels/paged_attention.py): D = 256 has kernels designed for it
# (csrc/flash_attention.cu, csrc/flash_attention_bwd.cu and
# csrc/paged_attention.cu name their D = 256 choices)
HEAD_DIMS = (64, 128, 256)
# calls that ``plain_head_dim`` sent to a plain version: SDPA and the paged
# wrappers at a head dim the reference itself runs no Pallas kernel for
plain_head_dim_calls = 0


def head_dim_route(head_dim):
    """Where an attention call at ``head_dim`` goes on the card, by the
    head dim alone: ``"kernel"`` for ``HEAD_DIMS``; ``"raise"`` for the
    other multiples of 128 (384 and up), which the reference sends to its
    Pallas kernels (``paddle_tpu/nn/functional/attention.py:75-100``,
    ``paddle_tpu/serving/kernels/paged_attention.py:414-446``) and the port
    has no instance for (ROADMAP A.3); ``"plain"`` for every other, which
    the reference computes with XLA on purpose (``_sdpa_reference``,
    ``paged_attention_reference``)."""
    if head_dim in HEAD_DIMS:
        return "kernel"
    return "raise" if head_dim % 128 == 0 else "plain"


def plain_head_dim(head_dim, *tensors):
    """True (and counted in ``plain_head_dim_calls``) when
    ``head_dim_route`` sends ``head_dim`` to the plain version and
    ``tensors`` lie on one CPU or CUDA device (other placements go on to
    the wrappers, which raise); decided before any launch, never after an
    error."""
    global plain_head_dim_calls
    if head_dim_route(head_dim) != "plain":
        return False
    devices = {t.device for t in tensors}
    if len(devices) != 1 or next(iter(devices)).type not in ("cpu", "cuda"):
        return False
    plain_head_dim_calls += 1
    return True


def no_kernel_message(what, head_dim):
    return ("%s: head_dim %d has no kernel (the kernels take %s; ROADMAP "
            "A.3 queues the rest)" % (what, head_dim, HEAD_DIMS))

# kernel launches since the last reset (chip_smoke.py reads and resets
# them): the forward, the backward's dq kernel and its dk/dv kernel,
# without and with segment ids, and float16 launches (either way) on
# counters of their own
launches = 0
dq_launches = 0
dkv_launches = 0
segmented_fwd_launches = 0
segmented_dq_launches = 0
segmented_dkv_launches = 0
f16_launches = 0
f16_dq_launches = 0
f16_dkv_launches = 0
# bf16 or float16 operands the forward or backward copied because TMA
# could not read them in place (``tma_aligned``); 0 on every main path
tma_copies = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# q, k, v, out, lse; sizes; the strides of q, k and v; scale, causal,
# dtype, segment ids (None = off), stream
_SIGNATURES = {"pt_flash_attention_fwd": [_P] * 5 + [_I] * 6 + [_L] * 9
               + [ctypes.c_float, _I, _I, _P, _P]}
# q, k, v, dO, lse, delta, then dq (or dk, dv); sizes; the strides of q,
# k, v and dO; scale, causal, dtype, segment ids (None = off), stream
_BWD_ARGS = [_I] * 6 + [_L] * 12 + [ctypes.c_float, _I, _I, _P, _P]
_BWD_SIGNATURES = {"pt_flash_attention_bwd_dq": [_P] * 7 + _BWD_ARGS,
                   "pt_flash_attention_bwd_dkv": [_P] * 8 + _BWD_ARGS}


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


def _segments(segment_ids, q, k, what):
    """``segment_ids`` (a tensor on q's device, or anything
    ``torch.as_tensor`` takes) as a contiguous ``[B, N]`` int32 tensor on
    q's device; None stays None."""
    if segment_ids is None:
        return None
    b, n = q.shape[:2]
    if k.shape[1] != n:
        raise ValueError(
            "segment_ids requires q_len == kv_len (packed batches)")
    if isinstance(segment_ids, torch.Tensor):
        if segment_ids.device != q.device:
            raise ValueError("%s: segment_ids on %s, q on %s"
                             % (what, segment_ids.device, q.device))
        segs = segment_ids
    else:
        segs = torch.as_tensor(segment_ids, device=q.device)
    if tuple(segs.shape) != (b, n):
        raise ValueError("%s: segment_ids has shape %s, not [B, N] = %s"
                         % (what, tuple(segs.shape), (b, n)))
    if segs.dtype.is_floating_point or segs.dtype.is_complex \
            or segs.dtype == torch.bool:
        raise ValueError("%s: segment_ids must be integers, got %s"
                         % (what, segs.dtype))
    return segs.to(torch.int32).contiguous()


def _segs_ptr(segs):
    return None if segs is None else segs.data_ptr()


def _acc_dtype(x):
    """float32 statistics for float32, bfloat16 and float16 inputs;
    float64 stays float64 (gradcheck)."""
    return torch.promote_types(x.dtype, torch.float32)


def _repeat_kv(x, heads):
    return x if x.shape[2] == heads else x.repeat_interleave(
        heads // x.shape[2], dim=2)


def _logits(q, k, causal, scale, segs=None):
    """Scaled scores ``[B, H, N, N_kv]`` in the accumulation dtype (k
    already repeated to q's heads), start-aligned-causal-masked and, with
    ``segs [B, N]``, masked where the query's and key's ids differ."""
    acc = _acc_dtype(q)
    logits = torch.einsum("bnhd,bmhd->bhnm", q.to(acc), k.to(acc)) * scale
    if causal:
        keep = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool,
                          device=q.device).tril()
        logits = logits.masked_fill(~keep, NEG_INF)
    if segs is not None:
        same = segs[:, :, None] == segs[:, None, :]          # [B, N, N]
        logits = logits.masked_fill(~same[:, None], NEG_INF)
    return logits


def flash_attention_reference(q, k, v, causal=False, scale=None,
                              segment_ids=None):
    """Plain PyTorch version: fp32 logits and softmax (float64 for
    float64 inputs) over the whole score matrix, same mask and output
    dtype as the kernel. Returns
    ``(out [B, N, H, D], lse [B*H, N] float32)``."""
    _check_shapes(q, k, v)
    segs = _segments(segment_ids, q, k, "flash_attention")
    b, n, h, d = q.shape
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    k, v = _repeat_kv(k, h), _repeat_kv(v, h)
    logits = _logits(q, k, causal, scale, segs)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", probs.to(v.dtype), v)
    return out, lse.reshape(b * h, n)


def flash_attention(q, k, v, causal=False, scale=None, segment_ids=None):
    """q ``[B, N, H, D]``, k/v ``[B, N_kv, H_kv, D]`` (``H % H_kv == 0``),
    optional ``segment_ids [B, N]`` (needs ``N_kv == N``)
    -> ``(out [B, N, H, D], lse [B*H, N] float32)``.

    CUDA tensors launch the kernel (float32, bfloat16 or float16,
    head_dim 64, 128 or 256, last axis contiguous; bf16 and float16 on
    ``wgmma`` with TMA loads, float32 on the CUDA cores) or raise; CPU
    tensors take the plain version."""
    _check_shapes(q, k, v)
    b, n, h, d = q.shape
    n_kv, h_kv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    dev = q.device
    if dev.type == "cpu" and k.device == dev and v.device == dev:
        return flash_attention_reference(q, k, v, causal, scale, segment_ids)
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("flash_attention: q, k, v must all be on one CUDA "
                         "device or all on the CPU (got %s, %s, %s)"
                         % (q.device, k.device, v.device))
    if (q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype
            or v.dtype != q.dtype):
        raise ValueError("flash_attention: the kernel takes float32, "
                         "bfloat16 or float16 q/k/v of one dtype, got "
                         "%s/%s/%s" % (q.dtype, k.dtype, v.dtype))
    if d not in HEAD_DIMS:
        raise ValueError(no_kernel_message("flash_attention", d))
    if n == 0 or n_kv == 0:
        raise ValueError("flash_attention: empty sequence")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention: the head_dim axis must be "
                         "contiguous")
    if b * h > 65535:
        raise ValueError("flash_attention: B*H = %d exceeds the grid limit"
                         % (b * h))
    segs = _segments(segment_ids, q, k, "flash_attention")
    q, k, v = _tma_operands(q, k, v)
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b * h, n), dtype=torch.float32, device=dev)
    lib = _build.load("flash_attention", _SIGNATURES)
    err = lib.pt_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, n, n_kv, h, h_kv, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        scale, int(bool(causal)), _build.DTYPE_CODES[q.dtype],
        _segs_ptr(segs), _build.stream_handle(dev))
    _build.check(lib, err, "flash_attention")
    global launches, segmented_fwd_launches, f16_launches
    if q.dtype == torch.float16:
        f16_launches += 1
    elif segs is None:
        launches += 1
    else:
        segmented_fwd_launches += 1
    return out, lse


def tma_aligned(x):
    """Whether the bf16 and float16 kernels' TMA loads read ``x`` ``[B, N, H, D]``
    (last axis contiguous) in place: its address and the byte stride
    of every other axis are multiples of 16 bytes. The stride of a
    length-1 axis is never used and does not count."""
    size = x.element_size()
    return x.data_ptr() % 16 == 0 and all(
        stride * size % 16 == 0
        for length, stride in zip(x.shape[:-1], x.stride()[:-1])
        if length > 1)


def _tma_operands(*xs):
    """``xs``, each bf16 or float16 tensor that ``tma_aligned`` refuses
    replaced by a contiguous copy (counted in ``tma_copies``); float32
    tensors go to the CUDA-core kernels, which read any stride, as they
    are."""
    global tma_copies
    out = []
    for x in xs:
        if x.dtype != torch.float32 and not tma_aligned(x):
            x = x.clone(memory_format=torch.contiguous_format)
            tma_copies += 1
        out.append(x)
    return out


def _check_backward(q, k, v, out, lse, dout):
    _check_shapes(q, k, v)
    b, n, h, _ = q.shape
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError("flash_attention_backward: out %s / dout %s must "
                         "have q's shape %s" % (tuple(out.shape),
                                                tuple(dout.shape),
                                                tuple(q.shape)))
    if lse.shape != (b * h, n):
        raise ValueError("flash_attention_backward: lse %s is not [B*H, N] "
                         "= %s" % (tuple(lse.shape), (b * h, n)))


def flash_attention_backward_reference(q, k, v, out, lse, dout,
                                       causal=False, scale=None,
                                       segment_ids=None):
    """Plain PyTorch version of the backward over the whole score matrix,
    following the reference's ``_dq_kernel``/``_dkv_kernel`` formulas and
    bf16 rounding points: ``ds`` is cast to the input dtype before
    ``ds.K`` and ``ds^T.Q``, and ``p`` to ``dout``'s dtype before
    ``p^T.dO``. Returns ``(dq, dk, dv)`` in q's, k's and v's dtypes, with
    dk/dv for the kv heads (summed over each GQA group)."""
    _check_backward(q, k, v, out, lse, dout)
    segs = _segments(segment_ids, q, k, "flash_attention_backward")
    b, n, h, d = q.shape
    n_kv, h_kv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    acc = _acc_dtype(q)
    kr, vr = _repeat_kv(k, h), _repeat_kv(v, h)
    p = torch.exp(_logits(q, kr, causal, scale, segs)
                  - lse.to(acc).reshape(b, h, n, 1))
    delta = (dout.to(acc) * out.to(acc)).sum(-1).transpose(1, 2)[..., None]
    dp = torch.einsum("bnhd,bmhd->bhnm", dout.to(acc), vr.to(acc))
    ds = (p * (dp - delta)).to(q.dtype).to(acc)
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, kr.to(acc)) * scale
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, q.to(acc)) * scale
    dv = torch.einsum("bhnm,bnhd->bmhd", p.to(dout.dtype).to(acc),
                      dout.to(acc))
    rep = h // h_kv
    dk = dk.reshape(b, n_kv, h_kv, rep, d).sum(3)
    dv = dv.reshape(b, n_kv, h_kv, rep, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_backward(q, k, v, out, lse, dout, causal=False,
                             scale=None, segment_ids=None):
    """Gradients of ``flash_attention``: q/dout/out ``[B, N, H, D]``, k/v
    ``[B, N_kv, H_kv, D]``, lse ``[B*H, N]`` float32 (the forward's),
    the forward's ``segment_ids`` ->
    ``(dq [B, N, H, D], dk, dv [B, N_kv, H_kv, D])``.

    CUDA tensors launch the dq kernel and then the dk/dv kernel (same
    dtypes and head dims as the forward) or raise; CPU tensors take the
    plain version. ``delta = rowsum(dO * O)`` in float32 is one PyTorch
    reduction, as in the reference, outside the kernels."""
    _check_backward(q, k, v, out, lse, dout)
    tensors = (q, k, v, out, lse, dout)
    if all(t.device.type == "cpu" for t in tensors):
        return flash_attention_backward_reference(q, k, v, out, lse, dout,
                                                  causal, scale, segment_ids)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("flash_attention_backward: all tensors must be on "
                         "one CUDA device or all on the CPU")
    if (q.dtype not in _build.DTYPE_CODES
            or any(t.dtype != q.dtype for t in (k, v, out, dout))
            or lse.dtype != torch.float32):
        raise ValueError("flash_attention_backward: the kernels take "
                         "float32, bfloat16 or float16 q/k/v/out/dout of "
                         "one dtype and a float32 lse")
    b, n, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(no_kernel_message("flash_attention_backward", d))
    if n == 0 or k.shape[1] == 0:
        raise ValueError("flash_attention_backward: empty sequence")
    # autograd may hand over a broadcast gradient (stride 0): the kernels
    # read each row's D values contiguously
    if dout.stride(3) != 1:
        dout = dout.contiguous()
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention_backward: the head_dim axis must "
                         "be contiguous")
    if b * h > 65535:
        raise ValueError("flash_attention_backward: B*H = %d exceeds the "
                         "grid limit" % (b * h))
    segs = _segments(segment_ids, q, k, "flash_attention_backward")
    # the dq and dk/dv launches share any copy TMA needs
    q, k, v, dout = _tma_operands(q, k, v, dout)
    lse = lse.contiguous()
    # [B*H, N] contiguous (for B = 1 the reshape alone would be a view)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).reshape(
        b * h, n).contiguous()
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal, scale,
                                segs)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal,
                                     scale, segs)
    return dq, dk, dv


def _bwd_launch(fn, q, k, v, dout, lse, delta, outs, causal, scale, segs,
                what):
    b, n, h, d = q.shape
    if not (lse.is_contiguous() and delta.is_contiguous()):
        raise ValueError("%s: lse and delta must be contiguous [B*H, N]"
                         % what)
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    q, k, v, dout = _tma_operands(q, k, v, dout)
    lib = _build.load("flash_attention_bwd", _BWD_SIGNATURES)
    err = getattr(lib, fn)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *(o.data_ptr() for o in outs),
        b, n, k.shape[1], h, k.shape[2], d, *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], *dout.stride()[:3], scale,
        int(bool(causal)), _build.DTYPE_CODES[q.dtype], _segs_ptr(segs),
        _build.stream_handle(q.device))
    _build.check(lib, err, what)


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal=False,
                           scale=None, segment_ids=None):
    """The dq kernel's wrapper, on CUDA tensors that
    ``flash_attention_backward`` has checked; ``delta`` is ``[B*H, N]``
    float32. Returns dq ``[B, N, H, D]`` in q's dtype."""
    segs = _segments(segment_ids, q, k, "flash_attention_backward (dq)")
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _bwd_launch("pt_flash_attention_bwd_dq", q, k, v, dout, lse, delta,
                (dq,), causal, scale, segs, "flash_attention_backward (dq)")
    global dq_launches, segmented_dq_launches, f16_dq_launches
    if q.dtype == torch.float16:
        f16_dq_launches += 1
    elif segs is None:
        dq_launches += 1
    else:
        segmented_dq_launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal=False,
                            scale=None, segment_ids=None):
    """The dk/dv kernel's wrapper, on the same checked CUDA tensors.
    Returns dk, dv ``[B, N_kv, H_kv, D]`` in k's and v's dtypes."""
    segs = _segments(segment_ids, q, k, "flash_attention_backward (dk/dv)")
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _bwd_launch("pt_flash_attention_bwd_dkv", q, k, v, dout, lse, delta,
                (dk, dv), causal, scale, segs,
                "flash_attention_backward (dk/dv)")
    global dkv_launches, segmented_dkv_launches, f16_dkv_launches
    if q.dtype == torch.float16:
        f16_dkv_launches += 1
    elif segs is None:
        dkv_launches += 1
    else:
        segmented_dkv_launches += 1
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """``FlashAttention.apply(q, k, v, causal, scale, segment_ids=None)
    -> out``: the forward kernel, with the backward kernels as its
    gradient (the reference's ``_flash_core`` custom_vjp). Saves q, k, v,
    out, the LSE and the int32 segment ids; the ids get no gradient (the
    reference's float0 cotangent)."""

    @staticmethod
    def forward(ctx, q, k, v, causal=False, scale=None, segment_ids=None):
        segs = _segments(segment_ids, q, k, "flash_attention")
        out, lse = flash_attention(q, k, v, causal=causal, scale=scale,
                                   segment_ids=segs)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.segs = causal, scale, segs
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, dout,
                                              ctx.causal, ctx.scale,
                                              ctx.segs)
        return dq, dk, dv, None, None, None
