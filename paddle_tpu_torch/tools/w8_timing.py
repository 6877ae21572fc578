"""Time the int8-weight GEMM (kernel 10) of one checkout on one GPU.

    python3 paddle_tpu_torch/tools/w8_timing.py [ROOT] [--seed N]

Imports ``paddle_tpu_torch`` from ROOT (default: the checkout that holds
this file), so that two checkouts, for instance a parent commit unpacked
beside the working tree, are timed in turn on the same card within one
call (run it as a file, not with ``-m``). Comparing two trees: run it in
the order parent, change, change, parent in one command.

Each row calls the tree's ``kernels.quant.int8_weight_matmul`` on a
quantized random weight (``quantize_int8_weight``) of one of llama1b's
projection shapes (K -> N: 2048 -> 2048, 2048 -> 5504, 5504 -> 2048) and
fp32 activations of M = 16 rows (the decode step) or 256 (the mixed
step), and prints, per row: ``ms`` by CUDA events (median of 5 x 10 calls
after a warm-up, the wrapper's host cost included where the host is the
slower side), ``device_ms`` from ``torch.profiler`` (the kernel's own
device time per call), the plain version's ``plain_ms`` and, as
yardsticks, ``torch.matmul`` on the dequantized weight
(``matmul_dequantized_ms``) and on the fp32 weight (``matmul_fp32_ms``),
beside the card's bound. One JSON line with the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

SHAPES = ((2048, 2048), (2048, 5504), (5504, 2048))
ROWS = (16, 256)
HBM_BYTES_PER_S, FP32_FLOPS = 3.35e12, 67e12


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
    """The device time of the kernel (every CUDA kernel whose name holds
    "w8_gemm") per call, from the profiler."""
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
             and "w8_gemm" in evt.key)
    return us / 1e3 / calls


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?",
                    default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import torch

    from paddle_tpu_torch.kernels import quant

    if not Path(quant.__file__).resolve().is_relative_to(root):
        raise SystemExit("w8_timing: paddle_tpu_torch came from %s, not %s "
                         "(run this file, not -m)" % (quant.__file__, root))
    if not torch.cuda.is_available():
        raise SystemExit("w8_timing: no CUDA device")
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    out = {"root": root, "device": torch.cuda.get_device_name(0),
           "power_limit": power.stdout.strip().splitlines()[0], "rows": []}
    for k, n in SHAPES:
        w = torch.randn(k, n, generator=gen, device="cuda") * 0.02
        q, scales = quant.quantize_int8_weight(w)
        deq = quant.dequantize_int8_weight(q, scales)
        for m in ROWS:
            x = torch.randn(m, k, generator=gen, device="cuda")
            nbytes = q.numel() + scales.numel() * 4 + (m * k + m * n) * 4

            def kernel():
                return quant.int8_weight_matmul(x, q, scales)

            out["rows"].append({
                "m": m, "k": k, "n": n, "ms": time_ms(kernel),
                "device_ms": device_ms(kernel),
                "plain_ms": time_ms(
                    lambda: quant.int8_weight_matmul_reference(x, q,
                                                               scales)),
                "matmul_dequantized_ms": time_ms(lambda: torch.matmul(x,
                                                                      deq)),
                "matmul_fp32_ms": time_ms(lambda: torch.matmul(x, w)),
                "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                                2 * m * n * k / FP32_FLOPS) * 1e3})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
