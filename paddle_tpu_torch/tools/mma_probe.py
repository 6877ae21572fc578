"""Probe the bf16 tensor-core forms the port's kernels rely on, on one GPU.

    python3 -m paddle_tpu_torch.tools.mma_probe [--seed N]

Counterpart of ``tools/mosaic_probe.py``, which asks the TPU compiler
whether it takes four bf16 dot forms at BQ = BK = 512, D = 128 with fp32
results. Here each form runs through the fragment loads and ``mma.sync``
building blocks of ``csrc/mma_bf16.cuh`` (``csrc/mma_probe.cu``), and
all four again through the ``wgmma`` and TMA building blocks of
``csrc/wgmma_bf16.cuh`` that the bf16 flash-attention and fused CE
kernels use (nt with both operands K-major, nn with B MN-major,
the chained form with the accumulator handed over as the A operand, and
tn with A and B MN-major through rank-2 tensor maps). Unlike
the reference, its values are checked too: each result is held against
the same product of the same bf16 values taken in float32 by PyTorch. One
line per form, ``OK`` or ``FAIL``, as the reference prints them, with the
largest error; the exit code is 1 if any form fails.
"""
from __future__ import annotations

import argparse
import ctypes
import sys

import torch

from .. import _build

BQ, BK, D = 512, 512, 128
# name, form code, shapes of a and b
FORMS = (("nt bf16 (1,1)", 0, (BQ, D), (BK, D)),
         ("nn bf16 (1,0)", 1, (BQ, D), (D, BK)),
         ("tn bf16 (0,0)", 2, (D, BQ), (D, BK)),
         ("nt+cast+nn chained", 3, (BQ, D), (BK, D)),
         ("wgmma ss nt (K-major A, B)", 4, (BQ, D), (BK, D)),
         ("wgmma ss nn (B MN-major)", 5, (BQ, D), (D, BK)),
         ("wgmma ss nt+cast+rs nn chained", 6, (BQ, D), (BK, D)),
         ("wgmma ss tn (A and B MN-major)", 7, (D, BQ), (D, BK)))
# fp32 sums of 128 products taken in another order: a few fp32 ulps of
# sums whose terms are ~1e-2. The chained form rounds exp(s - 1) to bf16 on
# both sides; an s one fp32 ulp apart can round to the neighbouring bf16
# (2^-8 relative) in a few of the 512 terms of each output.
# The wgmma forms 4-7 take the same tolerances as their mma.sync
# counterparts 0, 1, 3 and 2: the same products, summed in another order.
TOL = {0: dict(atol=1e-5, rtol=1e-4), 1: dict(atol=1e-5, rtol=1e-4),
       2: dict(atol=1e-5, rtol=1e-4), 3: dict(atol=2e-3, rtol=1e-2),
       4: dict(atol=1e-5, rtol=1e-4), 5: dict(atol=1e-5, rtol=1e-4),
       6: dict(atol=2e-3, rtol=1e-2), 7: dict(atol=1e-5, rtol=1e-4)}
# the forms whose result is [512, 128] (the rest are [512, 512])
CHAINED = (3, 6)

launches = 0

_SIGNATURES = {"pt_mma_probe": [ctypes.c_int] + [ctypes.c_void_p] * 4}


def probe(form, a, b):
    """The kernel's result for ``form`` on contiguous bf16 CUDA tensors a, b
    of the form's shapes (fp32 ``[512, 512]``, or ``[512, 128]`` chained;
    TMA reads a and b, so their addresses are multiples of 16 bytes, as
    PyTorch's allocations are)."""
    shape_a, shape_b = FORMS[form][2:]
    if (a.device.type != "cuda" or b.device != a.device
            or a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16
            or tuple(a.shape) != shape_a or tuple(b.shape) != shape_b
            or not (a.is_contiguous() and b.is_contiguous())
            or (a.data_ptr() | b.data_ptr()) % 16):
        raise ValueError("mma_probe: form %d takes contiguous, 16-byte "
                         "aligned bf16 CUDA tensors %s and %s"
                         % (form, shape_a, shape_b))
    out = torch.empty((BQ, D if form in CHAINED else BK), dtype=torch.float32,
                      device=a.device)
    lib = _build.load("mma_probe", _SIGNATURES)
    err = lib.pt_mma_probe(form, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                           _build.stream_handle(a.device))
    _build.check(lib, err, "mma_probe form %d" % form)
    global launches
    launches += 1
    return out


def plain(form, a, b):
    """The same product in float32 on the same bf16 values."""
    a, b = a.float(), b.float()
    if form in (0, 4):
        return a @ b.T
    if form in (1, 5):
        return a @ b
    if form in (2, 7):
        return a.T @ b
    p = torch.exp(a @ b.T - 1.0).to(torch.bfloat16).float()
    return p @ b


def inputs(form, gen, device):
    """Random bf16 operands of the form's shapes (N(0, 0.1^2): the chained
    form's exp stays far from overflow)."""
    return [(torch.randn(shape, generator=gen, device=device) * 0.1)
            .to(torch.bfloat16) for shape in FORMS[form][2:]]


def run(seed=0, device="cuda"):
    """Run every form once; returns ``[{name, form, ok, max_abs_err}]``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = []
    for name, form, _, _ in FORMS:
        a, b = inputs(form, gen, device)
        got = probe(form, a, b)
        want = plain(form, a, b)
        torch.cuda.synchronize(device)
        err = (got - want).abs()
        tol = TOL[form]
        ok = bool(torch.isfinite(got).all()) and not bool(
            (err > tol["atol"] + tol["rtol"] * want.abs()).any())
        rows.append(dict(name=name, form=form, ok=ok,
                         max_abs_err=float(err.max())))
        print("%-4s %s -- max abs err %.3g (atol %g, rtol %g)" % (
            "OK" if ok else "FAIL", name, float(err.max()), tol["atol"],
            tol["rtol"]), flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mma_probe: no CUDA device")
    rows = run(args.seed)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
