"""Time the flash-attention kernels of one checkout on one GPU.

    python3 paddle_tpu_torch/tools/flash_timing.py [ROOT] [--seed N]

Imports ``paddle_tpu_torch`` from ROOT (default: the checkout that holds
this file), so that two checkouts, for instance a parent commit unpacked
beside the working tree, are timed in turn on the same card within one
call (run it as a file, not with ``-m``: ``-m`` imports the working
tree's package first). It times the forward, dq and dk/dv kernels (CUDA
events, median of 5 x 10 launches after a warm-up, as ``chip_smoke.py``)
at three shapes, all bf16 and causal:

  train    the llama1b training row's attention: B=8, N=1024, H=16, D=128
  bench    the reference's bench row: the same with H=6
  packed   the training shape with each row packing documents of 64-512
           tokens (segment ids, as ``chip_smoke.py`` phase 3d (a))

and prints one JSON line: ``{"root", "device", shape: {"fwd_ms",
"dq_ms", "dkv_ms"}}``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

SHAPES = {"train": 16, "bench": 6, "packed": 16}
BATCH, SEQ, HEAD_DIM = 8, 1024, 128


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
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    row = {"root": root, "device": torch.cuda.get_device_name(0)}
    for name, heads in SHAPES.items():
        shape = (BATCH, SEQ, heads, HEAD_DIM)
        q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda")
                         .bfloat16() for _ in range(4))
        segs = None
        if name == "packed":
            segs = torch.from_numpy(packed_ids(
                np.random.default_rng(args.seed + 8), BATCH, SEQ)).cuda()
        out, lse = fa.flash_attention(q, k, v, True, segment_ids=segs)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2) \
            .reshape(BATCH * heads, SEQ).contiguous()
        bwd = (q, k, v, dout, lse, delta, True, None, segs)
        row[name] = {
            "fwd_ms": time_ms(lambda: fa.flash_attention(
                q, k, v, True, segment_ids=segs)),
            "dq_ms": time_ms(lambda: fa.flash_attention_bwd_dq(*bwd)),
            "dkv_ms": time_ms(lambda: fa.flash_attention_bwd_dkv(*bwd))}
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
