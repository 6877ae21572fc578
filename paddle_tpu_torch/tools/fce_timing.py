"""Time the fused lm_head + CE kernels of one checkout on one GPU.

    python3 paddle_tpu_torch/tools/fce_timing.py [ROOT] [--seed N]
        [--rows NAME ...] [--clocks]

Imports ``paddle_tpu_torch`` from ROOT (default: the checkout that holds
this file), so that two checkouts, for instance a parent commit unpacked
beside the working tree, are timed in turn on the same card within one
call (run it as a file, not with ``-m``: ``-m`` imports the working
tree's package first). Comparing two trees: run it in the order parent,
change, change, parent in one command, so that a drift of the card's
clock shows as a difference between the two runs of one tree.

Three rows, through the tree's public wrappers (``kernels.fused_ce``), on
random inputs from --seed with 1/8 of the rows ignored (``--rows`` picks
some):

  train   T = 8192, H = 2048, V = 32000, bfloat16: the llama1b training
          row's loss tail (8 x 1024 tokens)
  train32 the same in float32: the float32 fused step's loss tail
          (``chip_smoke.py`` phase 6f)
  fp32    T = 1024, H = 2048, V = 32000, float32

Per row, for kernel 4 (``fwd``: ``fused_lm_head_ce_forward``), kernel 5
(``dh``: the dl and dh launches of ``fused_lm_head_ce_backward``) and
kernel 6 (``dw``: its dW launches):

  ms          CUDA events, median of 5 x 10 calls after a warm-up (3 x 3
              in float32); dh and dw are timed apart by the events the
              backward wrapper records around their launches
  device_ms   the kernels' own device time per call from the profiler
              (``fce_fwd*``; ``fce_bwd_dl*`` + ``fce_bwd_dh*``;
              ``fce_bwd_dw*``)
  bound_ms    operations at the card's peak (989 TFLOP/s bf16, 67 fp32):
              1, 2 and 1 T x H x V products
  library_ms  the yardstick, timed only: ``torch.matmul`` of the same
              products over the backward's vocab chunks (fwd: h . W[:, c];
              dh: h . W[:, c] and dl . W[:, c]^T; dw: h^T . dl)

and the port's unfused tail beside them (``unfused_fwd_ms``: ``h @ W``
then ``F.cross_entropy``; ``unfused_fwd_bwd_ms``: with the gradients of
h and W), and ``dw_chunk_device_ms``: the profiler's device time of one
dW launch alone, per vocab chunk (``"c0+cw"``), so that a ragged last
chunk's cost beside a full one shows. ``--clocks`` runs the forward, the
dl + dh launches and the dW launches each back to back for a second
while ``nvidia-smi`` samples the SM clock and the power draw every 50
ms, and adds their medians
(``clocks``: ``{fwd, dh, dw}``). It prints one JSON line: ``{"root",
"device", "power_limit", "train": {...}, "train32": {...}, "fp32":
{...}}``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROWS = {"train": (8192, 2048, 32000, "bfloat16"),
        "train32": (8192, 2048, 32000, "float32"),
        "fp32": (1024, 2048, 32000, "float32")}
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# profiler kernel names of each fused-CE kernel, by the table's number
KERNEL_NAMES = {"fwd": ("fce_fwd",), "dh": ("fce_bwd_dl", "fce_bwd_dh"),
                "dw": ("fce_bwd_dw",)}


def time_ms(fn, iters, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def device_ms(fn, calls=5):
    """Device time per call of each fused-CE kernel group, from the
    profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(KERNEL_NAMES, 0.0)
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for part, names in KERNEL_NAMES.items():
            if any(name in evt.key for name in names):
                out[part] += evt.self_device_time_total / 1e3 / calls
    return out


def library_products(h, w, plan):
    """``{fwd, dh, dw}``: callables taking ``torch.matmul`` of the fused-CE
    kernels' products over the vocab chunks ``plan`` (``[(c0, cw)]``), on
    a dl workspace of the chunks' width: the yardstick of ``library_ms``."""
    import torch

    chunk = max(cw for _, cw in plan)
    dl = torch.randn((h.shape[0], chunk), device=h.device).to(h.dtype)

    def fwd():
        for c0, cw in plan:
            torch.matmul(h, w[:, c0:c0 + cw])

    def dh():
        for c0, cw in plan:
            torch.matmul(h, w[:, c0:c0 + cw])
            torch.matmul(dl[:, :cw], w[:, c0:c0 + cw].T)

    def dw():
        for c0, cw in plan:
            torch.matmul(h.T, dl[:, :cw])

    return {"fwd": fwd, "dh": dh, "dw": dw}


def vocab_chunks(fc, vocab):
    """The backward's chunks ``[(c0, cw)]``, spelled out: trees before
    ``chunk_plan`` lack it."""
    chunk = fc.chunk_columns(vocab)
    return [(c0, min(chunk, vocab - c0)) for c0 in range(0, vocab, chunk)]


def backward_parts(fc, h, w, labels, lse, g_t):
    """``{dh, dw, dw_chunk}``: callables making the backward wrapper's dl
    + dh launches, or its dW launches, alone over the vocab chunks (through
    the tree's C entry points, as the wrapper calls them); ``dw_chunk(c0,
    cw)`` makes one chunk's dW launch."""
    import torch
    from paddle_tpu_torch import _build

    t_len, hid = h.shape
    vocab = w.shape[1]
    chunk = fc.chunk_columns(vocab)
    plan = vocab_chunks(fc, vocab)
    dl = torch.empty((t_len, chunk), dtype=h.dtype, device=h.device)
    acc = torch.empty((t_len, hid), device=h.device)
    out = torch.empty_like(h), torch.empty_like(w)
    code = _build.DTYPE_CODES[h.dtype]
    lib = _build.load("fused_ce", fc._SIGNATURES)
    stream = _build.stream_handle(h.device)
    labels = labels.to(torch.int32)

    def dh():
        for c0, cw in plan:
            _build.check(lib, lib.pt_fused_ce_bwd_dl(
                h.data_ptr(), w.data_ptr(), labels.data_ptr(), lse.data_ptr(),
                g_t.data_ptr(), dl.data_ptr(), t_len, hid, vocab, c0, cw,
                chunk, code, stream), "dl")
            _build.check(lib, lib.pt_fused_ce_bwd_dh(
                dl.data_ptr(), w.data_ptr(), acc.data_ptr(),
                out[0].data_ptr(), t_len, hid, vocab, c0, cw, chunk,
                int(c0 == 0), int(c0 + cw == vocab), code, stream), "dh")

    def dw_chunk(c0, cw):
        _build.check(lib, lib.pt_fused_ce_bwd_dw(
            h.data_ptr(), dl.data_ptr(), out[1].data_ptr(), t_len, hid,
            vocab, c0, cw, chunk, code, stream), "dw")

    def dw():
        for c0, cw in plan:
            dw_chunk(c0, cw)

    return {"dh": dh, "dw": dw, "dw_chunk": dw_chunk}


def time_row(fc, F, gen, t_len, hid, vocab, dtype_name, with_clocks=False):
    import torch

    dtype = getattr(torch, dtype_name)
    iters, reps = (10, 5) if dtype is torch.bfloat16 else (3, 3)
    h = torch.randn((t_len, hid), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((hid, vocab), generator=gen, device="cuda")
         * (2.0 / (hid + vocab)) ** 0.5).to(dtype)
    labels = torch.randint(0, vocab, (t_len,), generator=gen, device="cuda")
    labels[::8] = -100
    valid = labels != -100
    safe = torch.where(valid, labels, 0)
    g_t = torch.where(valid, 1.0 / valid.sum(), 0.0).float()
    _, lse = fc.fused_lm_head_ce_forward(h, w, safe)
    row = {"shape": "T=%d H=%d V=%d %s" % (t_len, hid, vocab, dtype_name)}
    ms = {"fwd": time_ms(lambda: fc.fused_lm_head_ce_forward(h, w, safe),
                         iters, reps)}
    split = []

    def backward():
        events = {}
        fc.fused_lm_head_ce_backward(h, w, safe, lse, g_t, events)
        split.append(events)
    ms["bwd"] = time_ms(backward, iters, reps)
    torch.cuda.synchronize()
    for part in ("dh", "dw"):
        ms[part] = statistics.median(
            sum(ev[part][i].elapsed_time(ev[part][i + 1])
                for i in range(0, len(ev[part]), 2)) for ev in split[1:])
    row["ms"] = ms

    def both():
        fc.fused_lm_head_ce_forward(h, w, safe)
        fc.fused_lm_head_ce_backward(h, w, safe, lse, g_t)
    row["device_ms"] = device_ms(both)
    product = 2.0 * t_len * hid * vocab / PEAK_FLOPS[dtype_name] * 1e3
    row["bound_ms"] = {"fwd": product, "dh": 2 * product, "dw": product}
    row["library_ms"] = {part: time_ms(fn, iters, reps) for part, fn in
                         library_products(h, w, vocab_chunks(fc, vocab))
                         .items()}
    parts = backward_parts(fc, h, w, safe, lse, g_t)
    parts["dh"]()   # the workspace holds the last chunk's dl
    row["dw_chunk_device_ms"] = {
        "%d+%d" % (c0, cw): device_ms(
            lambda: parts["dw_chunk"](c0, cw))["dw"]
        for c0, cw in vocab_chunks(fc, vocab)}
    if with_clocks:
        from paddle_tpu_torch.tools.flash_timing import clocks

        row["clocks"] = {
            "fwd": clocks(lambda: fc.fused_lm_head_ce_forward(h, w, safe)),
            "dh": clocks(parts["dh"]), "dw": clocks(parts["dw"])}
    hg = h.detach().requires_grad_()
    wg = w.detach().requires_grad_()
    row["unfused_fwd_ms"] = time_ms(
        lambda: F.cross_entropy(hg @ wg, labels), iters, reps)
    row["unfused_fwd_bwd_ms"] = time_ms(
        lambda: torch.autograd.grad(F.cross_entropy(hg @ wg, labels),
                                    (hg, wg)), iters, reps)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?",
                    default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", nargs="+", choices=list(ROWS),
                    default=list(ROWS))
    ap.add_argument("--clocks", action="store_true",
                    help="the SM clock and power draw under each kernel")
    args = ap.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import torch

    from paddle_tpu_torch.kernels import fused_ce as fc
    from paddle_tpu_torch.nn import functional as F

    if not Path(fc.__file__).resolve().is_relative_to(root):
        raise SystemExit("fce_timing: paddle_tpu_torch came from %s, not %s "
                         "(run this file, not -m)" % (fc.__file__, root))
    if not torch.cuda.is_available():
        raise SystemExit("fce_timing: no CUDA device")
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    out = {"root": root, "device": torch.cuda.get_device_name(0),
           "power_limit": power.stdout.strip().splitlines()[0]}
    for name in args.rows:
        out[name] = time_row(fc, F, gen, *ROWS[name], args.clocks)
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
