"""Fused lm_head + softmax cross-entropy: the CUDA kernels' wrappers, their
plain versions, the autograd function and the model-side gate.

Counterpart of ``paddle_tpu/kernels/fused_ce.py``. The decoder's loss tail
computes ``logits = h @ W`` (``[T, V]``, 0.5 GB in bf16 at the llama1b
training shape, plus fp32 copies in the loss and its gradient) and then
``logsumexp(logits) - logits[gold]``. The kernels of ``csrc/fused_ce.cu``
stream W tile by tile and never build the logits:

* ``fused_lm_head_ce_forward(h, w, labels) -> (loss, lse)`` launches the
  forward (per-split partial max / sum-exp / gold, then a combine); in
  bf16 and float16 the partials come from the same ``wgmma`` GEMM main
  loop as the backward's, one split per 256-column tile of the whole
  vocab;
* ``fused_lm_head_ce_backward(h, w, labels, lse, g_t) -> (dh, dw)``
  launches, per vocab chunk (``chunk_plan``), the dl kernel and the dh
  product (the reference's ``_dh_kernel``) and the dW product (its
  ``_dw_kernel``); in bf16 and float16 all three are one ``wgmma`` GEMM
  main loop with TMA loads and their own epilogues, in float32 CUDA-core
  tiles.

float16 (the reference's kernels take any float dtype) runs the bf16
kernels with float16 operands: sums in fp32, dl rounded to float16 where
the reference rounds it (``fused_ce.py:102, 128``), dh and dW written in
float16. Nothing is clamped: a small dl underflows to zero and a large dh
or dW overflows to inf where the plain version's rounding puts them, which
is what a ``GradScaler`` reads to skip a step.

Each wrapper takes its plain version (``..._reference``, over the whole
logits matrix in float32) for CPU tensors and launches the kernels or
raises for CUDA tensors: there is no fallback, and a float16 input is
never cast to float32. ``fwd_launches``, ``dh_launches`` and
``dw_launches`` count the wrapper calls that launched in float32 and
bf16, ``f16_fwd_launches``, ``f16_dh_launches`` and ``f16_dw_launches``
those in float16 (apart, as the flash kernels count theirs).

``FusedLMHeadCE`` is the ``torch.autograd.Function`` (the reference's
``custom_vjp``), ``fused_lm_head_ce`` the per-token loss with
``ignore_index``, ``fused_mean_ce`` the mean over valid tokens that the
Llama wiring uses, and ``fused_ce_applies`` the gate: the port's
``FLAGS_fused_lm_head_ce`` is on and the token count is a multiple of
``DEFAULT_BLOCK_T``. The reference has a third condition, a traced value
(with a warning for eager forwards), because JAX's eager tape cannot see
through its ``custom_vjp``; PyTorch's autograd differentiates an
``autograd.Function`` eagerly, so the port's eager ``TrainStep`` stands
where the reference's ``CompiledTrainStep`` does and that condition has no
counterpart. The reference's ``use_parallel`` term waits for tensor
parallelism in the port.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..core import flags as _flags
from ..core.dispatch import primitive

DEFAULT_BLOCK_T = 256
DEFAULT_IGNORE_INDEX = -100
# vocab columns a backward chunk covers at most (the dl workspace is
# [T, chunk] in the input dtype: 64 MB at T = 8192 in bf16)
MAX_CHUNK = 4096
_TILE = 128          # the float32 kernels' block tile (rows and columns)
_RESIDENT = 2        # float32 forward CTAs an SM holds (128 threads of
                     # ~250 registers, 48 KB of shared memory each)
_WGMMA_TILE_N = 256  # vocab columns of the bf16 kernels' tile (tc::TN)

fwd_launches = 0
dh_launches = 0
dw_launches = 0
f16_fwd_launches = 0
f16_dh_launches = 0
f16_dw_launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "pt_fused_ce_fwd": [_P] * 6 + [_I] * 5 + [_P],
    "pt_fused_ce_bwd_dl": [_P] * 6 + [_I] * 7 + [_P],
    "pt_fused_ce_bwd_dh": [_P] * 4 + [_I] * 9 + [_P],
    "pt_fused_ce_bwd_dw": [_P] * 3 + [_I] * 7 + [_P],
}


def _check_shapes(h, w, labels, what):
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[0]:
        raise ValueError("%s: h must be [T, H] and w [H, V], got %s and %s"
                         % (what, tuple(h.shape), tuple(w.shape)))
    if labels.shape != (h.shape[0],):
        raise ValueError("%s: labels %s must be [T] = [%d]"
                         % (what, tuple(labels.shape), h.shape[0]))


def _check_cuda(what, h, w, *tensors):
    """Raise unless every tensor sits on one CUDA device and h, w are what
    the kernels take; returns the dtype code."""
    dev = h.device
    if dev.type != "cuda" or any(t.device != dev for t in (w,) + tensors):
        raise ValueError("%s: all tensors must be on one CUDA device or all "
                         "on the CPU" % what)
    if h.dtype not in _build.DTYPE_CODES or w.dtype != h.dtype:
        raise ValueError("%s: the kernels take float32, bfloat16 or float16 "
                         "h and w of one dtype, got %s and %s"
                         % (what, h.dtype, w.dtype))
    if not (h.is_contiguous() and w.is_contiguous()):
        raise ValueError("%s: h and w must be contiguous" % what)
    t_len, hid = h.shape
    vocab = w.shape[1]
    if t_len == 0 or hid % 8 or vocab % 8 or not hid or not vocab:
        raise ValueError("%s: the kernels move 16-byte pieces: need T > 0 and "
                         "H, V multiples of 8, got T=%d H=%d V=%d"
                         % (what, t_len, hid, vocab))
    if any(t.data_ptr() % 16 for t in (h, w)):
        raise ValueError("%s: h and w must be 16-byte aligned" % what)
    return _build.DTYPE_CODES[h.dtype]


def chunk_columns(vocab):
    """Vocab columns per backward chunk: a multiple of 32, at most
    ``MAX_CHUNK``, and under V/4, so the dl workspace ``[T, chunk]`` stays
    far below half of ``T x V``."""
    return max(32, min(MAX_CHUNK, (vocab - 1) // 4 // 32 * 32))


def chunk_plan(vocab):
    """The backward's vocab chunks, ``[(c0, cw), ...]``: ``chunk_columns(V)``
    columns each, the last ``cw = V - c0`` wide; together they cover
    ``[0, V)`` once. The kernels read the dl workspace ``[T, chunk]``
    through a map of extent ``cw``, so columns a narrower last chunk
    leaves from the one before read as zeros."""
    chunk = chunk_columns(vocab)
    return [(c0, min(chunk, vocab - c0)) for c0 in range(0, vocab, chunk)]


@functools.lru_cache(maxsize=64)
def forward_splits(t_len, vocab, dtype=torch.float32, sms=132):
    """Vocab splits of the forward's partials. float32: each CTA walks
    ``ceil(vocab tiles / splits)`` tiles of 128 columns, and the count
    finishing soonest on ``sms`` SMs of ``_RESIDENT`` CTAs each wins: the
    fewest waves x tiles a CTA walks, then the fewest splits (longer walks,
    fewer partials; no split left empty). bfloat16 and float16: one split
    per 256-column tile of the ``wgmma`` product, ``ceil(V / 256)``, the
    count the C side requires."""
    if dtype in (torch.bfloat16, torch.float16):
        return -(-vocab // _WGMMA_TILE_N)
    t_tiles = -(-t_len // _TILE)
    v_tiles = -(-vocab // _TILE)
    slots = _RESIDENT * sms

    def cost(splits):
        return (-(-t_tiles * splits // slots)) * -(-v_tiles // splits)
    return min(range(1, v_tiles + 1), key=lambda s: (cost(s), s))


def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


# -- forward ------------------------------------------------------------------

def fused_lm_head_ce_forward_reference(h, w, labels):
    """Plain version: float32 logits over the whole ``[T, V]`` matrix.
    ``labels`` must lie in ``[0, V)``. Returns ``(loss, lse)``, float32
    ``[T]``, ``loss = lse - logits[label]``."""
    _check_shapes(h, w, labels, "fused_lm_head_ce_forward")
    logits = h.float() @ w.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(1, labels.long()[:, None])[:, 0]
    return lse - gold, lse


def fused_lm_head_ce_forward(h, w, labels):
    """h ``[T, H]``, w ``[H, V]``, labels ``[T]`` in ``[0, V)`` ->
    ``(loss [T], lse [T])`` float32, without building the logits.

    CUDA tensors launch the kernels (float32, bfloat16 or float16 h and w
    of one dtype, contiguous, 16-byte aligned, H and V multiples of 8) or
    raise; CPU tensors take the plain version."""
    _check_shapes(h, w, labels, "fused_lm_head_ce_forward")
    if all(t.device.type == "cpu" for t in (h, w, labels)):
        return fused_lm_head_ce_forward_reference(h, w, labels)
    dtype = _check_cuda("fused_lm_head_ce_forward", h, w, labels)
    t_len, hid = h.shape
    vocab = w.shape[1]
    labels = labels.to(torch.int32).contiguous()
    dev = h.device
    splits = forward_splits(t_len, vocab, h.dtype, _sm_count(dev))
    loss = torch.empty(t_len, dtype=torch.float32, device=dev)
    lse = torch.empty(t_len, dtype=torch.float32, device=dev)
    part = torch.empty((3, splits, t_len), dtype=torch.float32, device=dev)
    lib = _build.load("fused_ce", _SIGNATURES)
    err = lib.pt_fused_ce_fwd(
        h.data_ptr(), w.data_ptr(), labels.data_ptr(), loss.data_ptr(),
        lse.data_ptr(), part.data_ptr(), t_len, hid, vocab, splits, dtype,
        _build.stream_handle(dev))
    _build.check(lib, err, "fused_lm_head_ce_forward")
    global fwd_launches, f16_fwd_launches
    if h.dtype == torch.float16:
        f16_fwd_launches += 1
    else:
        fwd_launches += 1
    return loss, lse


# -- backward ---------------------------------------------------------------

def fused_lm_head_ce_backward_reference(h, w, labels, lse, g_t):
    """Plain version of the backward over the whole logits matrix:
    ``dl = (exp(logits - lse) - onehot) * g_t``, rounded to the input
    dtype where the reference rounds it (``fused_ce.py:102, 128``), then
    ``dh = dl . W^T`` and ``dW = h^T . dl`` in float32, returned in h's and
    w's dtypes."""
    _check_shapes(h, w, labels, "fused_lm_head_ce_backward")
    logits = h.float() @ w.float()
    p = torch.exp(logits - lse.float()[:, None])
    onehot = torch.nn.functional.one_hot(labels.long(), w.shape[1])
    dl = (p - onehot) * g_t.float()[:, None]
    dh = dl.to(w.dtype).float() @ w.float().T
    dw = h.float().T @ dl.to(h.dtype).float()
    return dh.to(h.dtype), dw.to(w.dtype)


def _mark(events, key):
    if events is not None:
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        events.setdefault(key, []).append(event)


def fused_lm_head_ce_backward(h, w, labels, lse, g_t, events=None):
    """Gradients of ``sum(loss * g_t)`` for the forward's ``lse``:
    ``(dh [T, H] in h's dtype, dw [H, V] in w's dtype)``. ``g_t`` is the
    float32 ``[T]`` upstream gradient, 0 on ignored rows.

    CUDA tensors run, per vocab chunk of ``chunk_columns(V)`` columns, the
    dl kernel, the dh product and the dW product (so the dl workspace is
    ``[T, chunk]``, never the logits), or raise; CPU tensors take the plain
    version. ``events``, a dict, collects CUDA events around the launches
    under ``"dh"`` (dl and dh) and ``"dw"``, for timing them apart."""
    _check_shapes(h, w, labels, "fused_lm_head_ce_backward")
    if all(t.device.type == "cpu" for t in (h, w, labels, lse, g_t)):
        return fused_lm_head_ce_backward_reference(h, w, labels, lse, g_t)
    dtype = _check_cuda("fused_lm_head_ce_backward", h, w, labels, lse, g_t)
    t_len, hid = h.shape
    vocab = w.shape[1]
    if lse.shape != (t_len,) or g_t.shape != (t_len,):
        raise ValueError("fused_lm_head_ce_backward: lse and g_t must be [T]")
    labels = labels.to(torch.int32).contiguous()
    lse = lse.float().contiguous()
    g_t = g_t.float().contiguous()
    chunk = chunk_columns(vocab)
    dev = h.device
    dl = torch.empty((t_len, chunk), dtype=h.dtype, device=dev)
    acc = (torch.empty((t_len, hid), dtype=torch.float32, device=dev)
           if chunk < vocab else None)
    dh = torch.empty((t_len, hid), dtype=h.dtype, device=dev)
    dw = torch.empty((hid, vocab), dtype=w.dtype, device=dev)
    lib = _build.load("fused_ce", _SIGNATURES)
    stream = _build.stream_handle(dev)
    acc_ptr = None if acc is None else acc.data_ptr()
    for c0, cw in chunk_plan(vocab):
        _mark(events, "dh")
        err = lib.pt_fused_ce_bwd_dl(
            h.data_ptr(), w.data_ptr(), labels.data_ptr(), lse.data_ptr(),
            g_t.data_ptr(), dl.data_ptr(), t_len, hid, vocab, c0, cw, chunk,
            dtype, stream)
        _build.check(lib, err, "fused_lm_head_ce_backward (dl)")
        err = lib.pt_fused_ce_bwd_dh(
            dl.data_ptr(), w.data_ptr(), acc_ptr, dh.data_ptr(), t_len, hid,
            vocab, c0, cw, chunk, int(c0 == 0), int(c0 + cw == vocab), dtype,
            stream)
        _build.check(lib, err, "fused_lm_head_ce_backward (dh)")
        _mark(events, "dh")
        _mark(events, "dw")
        err = lib.pt_fused_ce_bwd_dw(
            h.data_ptr(), dl.data_ptr(), dw.data_ptr(), t_len, hid, vocab, c0,
            cw, chunk, dtype, stream)
        _build.check(lib, err, "fused_lm_head_ce_backward (dw)")
        _mark(events, "dw")
    global dh_launches, dw_launches, f16_dh_launches, f16_dw_launches
    if h.dtype == torch.float16:
        f16_dh_launches += 1
        f16_dw_launches += 1
    else:
        dh_launches += 1
        dw_launches += 1
    return dh, dw


# -- autograd and the model-side API ---------------------------------------

class FusedLMHeadCE(torch.autograd.Function):
    """``FusedLMHeadCE.apply(h, w, safe_labels, valid) -> losses [T]``
    float32, 0 where ``valid`` is False; differentiable in h and w."""

    @staticmethod
    def forward(ctx, h, w, safe_labels, valid):
        loss, lse = fused_lm_head_ce_forward(h, w, safe_labels)
        ctx.save_for_backward(h, w, safe_labels, valid, lse)
        return torch.where(valid, loss, torch.zeros_like(loss))

    @staticmethod
    def backward(ctx, g):
        h, w, safe_labels, valid, lse = ctx.saved_tensors
        # autograd hands a sum's gradient over broadcast (stride 0); the
        # kernels read g_t as a contiguous [T] vector
        g_t = torch.where(valid, g.float(), torch.zeros_like(lse))
        dh, dw = fused_lm_head_ce_backward(h, w, safe_labels, lse,
                                           g_t.contiguous())
        return dh, dw, None, None


def fused_lm_head_ce(h, w, labels, ignore_index=DEFAULT_IGNORE_INDEX,
                     block_t=DEFAULT_BLOCK_T):
    """Per-token cross-entropy of ``h [T, H] @ w [H, V]`` against
    ``labels [T]`` without building the logits: float32 ``[T]``, 0.0 at
    ``ignore_index`` rows. ``T % block_t`` must be 0, as in the reference
    (the vocab needs no alignment beyond the kernels' multiple of 8)."""
    t_len = h.shape[0]
    if t_len % block_t:
        raise ValueError(
            "fused_lm_head_ce: block_t %d must divide the token count %d "
            "(vocab is padded to the block internally)" % (block_t, t_len))
    valid = labels != ignore_index
    # ignored rows pick column 0's logit; masked to 0 either way
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    return FusedLMHeadCE.apply(h, w, safe.to(torch.int32), valid)


@primitive(name="fused_lm_head_ce")
def fused_mean_ce(h2d, w, labels_flat):
    """Mean cross-entropy over the non-ignored tokens through the fused
    kernels: the loss tail the model wiring calls. ``h2d`` and ``w`` of
    two dtypes (float32 hidden states from a black-listed norm under O1
    beside bf16 weights) meet in their promoted dtype, as ``jnp`` promotes
    the reference's operands."""
    dt = torch.promote_types(h2d.dtype, w.dtype)
    h2d, w = h2d.to(dt), w.to(dt)
    per_tok = fused_lm_head_ce(h2d, w, labels_flat, DEFAULT_IGNORE_INDEX,
                               DEFAULT_BLOCK_T)
    valid = (labels_flat != DEFAULT_IGNORE_INDEX).to(per_tok.dtype)
    return per_tok.sum() / valid.sum().clamp(min=1.0)


def fused_ce_applies(h):
    """The gate for ``h [B, S, H]``: ``FLAGS_fused_lm_head_ce`` is on and
    ``B * S`` is a multiple of ``DEFAULT_BLOCK_T``."""
    if not _flags.get_flags("FLAGS_fused_lm_head_ce")[
            "FLAGS_fused_lm_head_ce"]:
        return False
    b, s, _ = h.shape
    return (b * s) % DEFAULT_BLOCK_T == 0
