"""Time the flash-attention kernels of one checkout on one GPU.

    python3 paddle_tpu_torch/tools/flash_timing.py [ROOT] [--seed N]

Imports ``paddle_tpu_torch`` from ROOT (default: the checkout that holds
this file), so that two checkouts, for instance a parent commit unpacked
beside the working tree, are timed in turn on the same card within one
call (run it as a file, not with ``-m``: ``-m`` imports the working
tree's package first). Comparing two trees: run it in the order parent,
change, change, parent in one command, so that a drift of the card's
clock shows as a difference between the two runs of one tree.

It times the forward, dq and dk/dv kernels and, beside them, torch
SDPA's forward on the same inputs (CUDA events, median of 5 x 10
launches after a warm-up, as ``chip_smoke.py``) at seven shapes:

  train    the llama1b training row's attention: B=8, N=1024, H=16,
           D=128, bf16, causal
  bench    the reference's bench row: the same with H=6
  packed   the training shape with each row packing documents of 64-512
           tokens (segment ids, as ``chip_smoke.py`` phase 3d (a); SDPA
           with a dense boolean mask)
  serving  llama1b's largest prefill bucket: B=1, N=2048, H=16, D=128,
           float32, causal; serving1024 and serving512 the same at
           shorter buckets (the float32 kernel's 64-row tiles)
  shuffled float32, B=1, N=2048, H=16, non-causal, 8 shuffled ids (phase
           3d (b); SDPA with a dense boolean mask)

and prints one JSON line: ``{"root", "device", "power_limit", shape:
{"fwd_ms", "dq_ms", "dkv_ms", "sdpa_ms"}}``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

# shape: (batch, sequence, heads, dtype, causal, segment ids)
SHAPES = {"train": (8, 1024, 16, "bfloat16", True, None),
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?",
                    default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--seed", type=int, default=0)
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
    for name, (batch, n, heads, dtype, causal, ids) in SHAPES.items():
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
        row[name] = {
            "fwd_ms": time_ms(lambda: fa.flash_attention(
                q, k, v, causal, segment_ids=segs)),
            "dq_ms": time_ms(lambda: fa.flash_attention_bwd_dq(*bwd)),
            "dkv_ms": time_ms(lambda: fa.flash_attention_bwd_dkv(*bwd)),
            "sdpa_ms": time_ms(
                lambda: sdpa(qt, kt, vt, is_causal=causal) if mask is None
                else sdpa(qt, kt, vt, attn_mask=mask))}
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
