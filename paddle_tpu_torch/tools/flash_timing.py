"""Time the flash-attention kernels of one checkout on one GPU.

    python3 paddle_tpu_torch/tools/flash_timing.py [ROOT] [--seed N]
        [--shapes NAME ...] [--clocks]

Imports ``paddle_tpu_torch`` from ROOT (default: the checkout that holds
this file), so that two checkouts, for instance a parent commit unpacked
beside the working tree, are timed in turn on the same card within one
call (run it as a file, not with ``-m``: ``-m`` imports the working
tree's package first). Comparing two trees: run it in the order parent,
change, change, parent in one command, so that a drift of the card's
clock shows as a difference between the two runs of one tree.

It times the forward, dq and dk/dv kernels and, beside them, torch
SDPA's forward on the same inputs (CUDA events, median of 5 x 10
launches after a warm-up, as ``chip_smoke.py``; ``*_ms``), and the
kernels' own device time from ``torch.profiler`` (``*_device_ms``, per
launch over 10 launches), at eight shapes:

  train    the llama1b training row's attention: B=8, N=1024, H=16,
           D=128, bf16, causal
  train32  the same in float32, the llama1b config's default dtype
  bench    the reference's bench row: the same with H=6
  packed   the training shape with each row packing documents of 64-512
           tokens (segment ids, as ``chip_smoke.py`` phase 3d (a); SDPA
           with a dense boolean mask)
  serving  llama1b's largest prefill bucket: B=1, N=2048, H=16, D=128,
           float32, causal; serving1024 and serving512 the same at
           shorter buckets (the float32 kernel's 64-row tiles)
  shuffled float32, B=1, N=2048, H=16, non-causal, 8 shuffled ids (phase
           3d (b); SDPA with a dense boolean mask)

At the float32 shapes SDPA's backward is timed too (``sdpa_bwd_ms``:
``autograd.grad`` of one SDPA forward, dq, dk and dv together).
``--shapes`` times only the shapes named. ``--clocks`` runs dq and dk/dv
back to back for a second each at the float32 shapes while
``nvidia-smi`` samples the SM clock and the power draw every 50 ms, and
adds their medians (``dq_clocks``, ``dkv_clocks``). It prints one JSON
line: ``{"root", "device", "power_limit", shape: {"fwd_ms", "dq_ms",
"dkv_ms", "sdpa_ms", "fwd_device_ms", "dq_device_ms", "dkv_device_ms"[,
"sdpa_bwd_ms"]}}``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

# shape: (batch, sequence, heads, dtype, causal, segment ids)
SHAPES = {"train": (8, 1024, 16, "bfloat16", True, None),
          "train32": (8, 1024, 16, "float32", True, None),
          "bench": (8, 1024, 6, "bfloat16", True, None),
          "packed": (8, 1024, 16, "bfloat16", True, "packed"),
          "serving": (1, 2048, 16, "float32", True, None),
          "serving1024": (1, 1024, 16, "float32", True, None),
          "serving512": (1, 512, 16, "float32", True, None),
          "shuffled": (1, 2048, 16, "float32", False, "shuffled")}
HEAD_DIM = 128


def packed_ids(rng, batch, n, lo=64, hi=512):
    """[batch, n] int32 ids: each row packs documents of lengths uniform in
    [lo, hi], the last one cut to fit (``chip_smoke.packed_ids``)."""
    import numpy as np

    ids = np.zeros((batch, n), np.int32)
    for r in range(batch):
        off, doc = 0, 0
        while off < n:
            length = min(int(rng.integers(lo, hi + 1)), n - off)
            ids[r, off:off + length] = doc
            off, doc = off + length, doc + 1
    return ids


def shuffled_ids(rng, batch, n, groups=8):
    """Ids in no order (``chip_smoke.shuffled_ids``)."""
    import numpy as np

    return (rng.integers(0, groups, (batch, n)) * 5 - 7).astype(np.int32)


def time_ms(fn, iters=10, reps=5):
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


def device_ms(fn, name, calls=10, tries=3):
    """The device time per call of the CUDA kernels whose names hold
    ``name``, from the profiler. A window in which the profiler recorded
    fewer launches than were made is measured again."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        evts = [evt for evt in prof.key_averages()
                if evt.device_type == torch.autograd.DeviceType.CUDA
                and name in evt.key]
        if sum(evt.count for evt in evts) == calls:
            break
    else:
        raise RuntimeError("flash_timing: the profiler recorded %d of %d "
                           "%s launches" % (sum(e.count for e in evts),
                                            calls, name))
    return sum(evt.self_device_time_total for evt in evts) / 1e3 / calls


def clocks(fn, seconds=1.0):
    """The median SM clock (MHz) and power draw (W) of ``nvidia-smi``'s
    samples, every 50 ms, while ``fn`` runs back to back for ``seconds``."""
    import torch

    fn()
    torch.cuda.synchronize()
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=60)
    samples = []
    for line in out.splitlines():
        try:
            samples.append([float(x) for x in line.split(",")])
        except ValueError:   # a partial last line or "[N/A]"
            continue
    if not samples:
        raise RuntimeError("flash_timing: nvidia-smi gave no samples")
    return {"sm_mhz": statistics.median(x[0] for x in samples),
            "power_w": statistics.median(x[1] for x in samples),
            "samples": len(samples)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?",
                    default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shapes", nargs="+", choices=sorted(SHAPES),
                    default=list(SHAPES))
    ap.add_argument("--clocks", action="store_true",
                    help="the SM clock and power draw under dq and dk/dv")
    args = ap.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from paddle_tpu_torch.kernels import flash_attention as fa

    if not Path(fa.__file__).resolve().is_relative_to(root):
        raise SystemExit("flash_timing: paddle_tpu_torch came from %s, not "
                         "%s (run this file, not -m)" % (fa.__file__, root))
    if not torch.cuda.is_available():
        raise SystemExit("flash_timing: no CUDA device")
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    row = {"root": root, "device": torch.cuda.get_device_name(0),
           "power_limit": power.stdout.strip().splitlines()[0]}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name in args.shapes:
        batch, n, heads, dtype, causal, ids = SHAPES[name]
        shape = (batch, n, heads, HEAD_DIM)
        q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda")
                         .to(getattr(torch, dtype)) for _ in range(4))
        segs = mask = None
        if ids is not None:
            make = packed_ids if ids == "packed" else shuffled_ids
            segs = torch.from_numpy(make(np.random.default_rng(
                args.seed + (8 if ids == "packed" else 9)), batch, n)).cuda()
            mask = segs[:, :, None] == segs[:, None, :]
            if causal:
                mask &= torch.ones(n, n, dtype=torch.bool,
                                   device="cuda").tril()
            mask = mask[:, None]
        out, lse = fa.flash_attention(q, k, v, causal, segment_ids=segs)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2) \
            .reshape(batch * heads, n).contiguous()
        bwd = (q, k, v, dout, lse, delta, causal, None, segs)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def fwd():
            return fa.flash_attention(q, k, v, causal, segment_ids=segs)

        def dq():
            return fa.flash_attention_bwd_dq(*bwd)

        def dkv():
            return fa.flash_attention_bwd_dkv(*bwd)

        def library(qt=qt, kt=kt, vt=vt):
            return (sdpa(qt, kt, vt, is_causal=causal) if mask is None
                    else sdpa(qt, kt, vt, attn_mask=mask))

        row[name] = {
            "fwd_ms": time_ms(fwd), "dq_ms": time_ms(dq),
            "dkv_ms": time_ms(dkv), "sdpa_ms": time_ms(library),
            "fwd_device_ms": device_ms(fwd, "flash_fwd"),
            "dq_device_ms": device_ms(dq, "flash_bwd_dq"),
            "dkv_device_ms": device_ms(dkv, "flash_bwd_dkv")}
        if dtype == "float32":
            leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
            lib_out = library(*leaves)
            row[name]["sdpa_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
                lib_out, leaves, dout.transpose(1, 2), retain_graph=True))
            if args.clocks:
                row[name]["dq_clocks"] = clocks(dq)
                row[name]["dkv_clocks"] = clocks(dkv)
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
