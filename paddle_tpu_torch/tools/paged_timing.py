"""Time the paged-attention kernels of one checkout on one GPU.

    python3 paddle_tpu_torch/tools/paged_timing.py [ROOT] [--seed N]

Imports ``paddle_tpu_torch`` from ROOT (default: the checkout that holds
this file), so that two checkouts, for instance a parent commit unpacked
beside the working tree, are timed in turn on the same card within one
call (run it as a file, not with ``-m``: ``-m`` imports the working
tree's package first). Comparing two trees: run it in the order parent,
change, change, parent in one command, so that a drift of the card's
clock shows as a difference between the two runs of one tree.

Each row goes through the tree's own public wrappers
(``serving.kernels.paged_attention.paged_attention`` and
``mixed_paged_attention``) on pools of shuffled 16-token pages, llama1b's
attention (H = Hkv = 16, D = 128, float32 queries), and is timed twice:
``ms`` with CUDA events, median of 5 x 10 calls after a warm-up, as
``chip_smoke.py`` (the wrapper's host cost included where the host is
the slower side), and ``device_ms``, the kernels' own device time per
call (split and combine kernels together) from ``torch.profiler`` over
10 calls:

  decode        kernel 7, 16 slots over chip_smoke's PAGED_LENS
                (0 .. 2048 tokens), float32 pages
  decode_int8   the same over int8 pages with float32 scales
  mixed         kernel 8 at (a): a mixed step of 16 slots x 16-token
                chunks over histories 0 .. 2000, float32 pages
  mixed_int8    the same over int8 pages
  suffix        kernel 8 at (b): one suffix prefill, the 1024 bucket,
                1000 new tokens after a 512-token cached prefix

and prints one JSON line: ``{"root", "device", "power_limit", row:
{"ms", "device_ms", "split"}}``, ``split`` being the tree's split plan
where it has one (``split_plan``), else null.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

# chip_smoke.py's shapes (PAGED_LENS, MIXED_STEP, SUFFIX_PREFILL)
PAGED_LENS = [0, 1, 15, 16, 17, 100, 257, 512, 777, 1000, 1023, 1500, 1999,
              2047, 2048, 0]
MIXED_HIST = [0, 5, 17, 100, 250, 513, 777, 1000, 1023, 1250, 1500, 1777,
              1900, 2000, 31, 0]
MIXED_QLEN = [16, 1, 16, 7, 1, 16, 1, 0, 12, 1, 16, 3, 1, 16, 0, 1]
HEADS, HEAD_DIM, BLOCK, MAX_BLOCKS = 16, 128, 16, 128


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


def device_ms(fn, calls=10):
    """The device time of the paged kernels (every CUDA kernel whose name
    holds "paged") per call, from the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(evt.self_device_time_total for evt in prof.key_averages()
             if evt.device_type == torch.autograd.DeviceType.CUDA
             and "paged" in evt.key)
    return us / 1e3 / calls


def pages(gen, totals, int8):
    """Pools holding ``totals[s]`` tokens per slot on shuffled pages, the
    block tables, and with ``int8`` the int8 pools and scale planes."""
    import torch

    from paddle_tpu_torch.kernels.quant import quantize_int8_page

    n_pages = [-(-n // BLOCK) for n in totals]
    num_blocks = sum(n_pages) + 1
    ids = (torch.randperm(num_blocks - 1, generator=torch.Generator()
                          .manual_seed(sum(totals))) + 1).tolist()
    table = torch.zeros((len(totals), MAX_BLOCKS), dtype=torch.int32)
    for i, n in enumerate(n_pages):
        table[i, :n] = torch.tensor([ids.pop() for _ in range(n)])
    shape = (num_blocks, BLOCK, HEADS, HEAD_DIM)
    k = torch.randn(shape, generator=gen, device="cuda")
    v = torch.randn(shape, generator=gen, device="cuda")
    if not int8:
        return dict(k_pool=k, v_pool=v), table.cuda()
    kq, ks = quantize_int8_page(k)
    vq, vs = quantize_int8_page(v)
    return dict(k_pool=kq, v_pool=vq, k_scale=ks, v_scale=vs), table.cuda()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?",
                    default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import torch

    from paddle_tpu_torch.serving.kernels import paged_attention as pa

    if not Path(pa.__file__).resolve().is_relative_to(root):
        raise SystemExit("paged_timing: paddle_tpu_torch came from %s, not "
                         "%s (run this file, not -m)" % (pa.__file__, root))
    if not torch.cuda.is_available():
        raise SystemExit("paged_timing: no CUDA device")
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    row = {"root": root, "device": torch.cuda.get_device_name(0),
           "power_limit": power.stdout.strip().splitlines()[0]}
    plan = getattr(pa, "split_plan", None)

    def split(slots, chunk, decode=False):
        if plan is None:
            return None
        return plan(slots, chunk, HEADS, HEADS, MAX_BLOCKS, BLOCK,
                    decode=decode)._asdict()

    for int8 in (False, True):
        tag = "_int8" if int8 else ""
        kv, bt = pages(gen, PAGED_LENS, int8)
        q = torch.randn((len(PAGED_LENS), HEADS, HEAD_DIM), generator=gen,
                        device="cuda")
        sl = torch.tensor(PAGED_LENS, dtype=torch.int32, device="cuda")

        def decode():
            return pa.paged_attention(q, block_tables=bt, seq_lens=sl, **kv)

        row["decode" + tag] = {
            "ms": time_ms(decode), "device_ms": device_ms(decode),
            "split": split(len(PAGED_LENS), 1, decode=True)}
        cases = [("mixed", MIXED_HIST, MIXED_QLEN, 16)]
        if not int8:
            cases.append(("suffix", [512], [1000], 1024))
        for name, hist, qlen, chunk in cases:
            totals = [h + n if n else 0 for h, n in zip(hist, qlen)]
            kv, bt = pages(gen, totals, int8)
            q = torch.randn((len(hist), chunk, HEADS, HEAD_DIM),
                            generator=gen, device="cuda")
            call = dict(block_tables=bt, **kv,
                        hist_lens=torch.tensor(hist, dtype=torch.int32,
                                               device="cuda"),
                        q_lens=torch.tensor(qlen, dtype=torch.int32,
                                            device="cuda"))

            def step():
                return pa.mixed_paged_attention(q, **call)

            row[name + tag] = {
                "ms": time_ms(step), "device_ms": device_ms(step),
                "split": split(len(hist), chunk)}
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
