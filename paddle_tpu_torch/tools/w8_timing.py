"""Time the int8-weight GEMM (kernel 10) of one checkout on one GPU.

    python3 paddle_tpu_torch/tools/w8_timing.py [ROOT] [--seed N]
        [--bfloat16] [--sweep] [--clusters]

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
beside the card's bound and the tree's plan for the shape; and, per M,
one llama1b layer's seven projections summed (``layers``: q/k/v/o at
2048 -> 2048, gate/up at 2048 -> 5504, down at 5504 -> 2048). One JSON
line with the card's name and power limit.

``--bfloat16`` times the kernel's bf16 mode instead: bf16 activations
(and a bf16 weight quantized), the plan ``w8_plan_bf16`` gives where the
tree has one, the bound at the bf16 tensor-core peak, and as the yardstick
``torch.matmul`` on the weight dequantized to bf16
(``matmul_dequantized_ms``; no fp32-weight row). A parent tree whose tool
lacks the flag is timed by this file with the parent as ROOT.

Two options read the plan's inputs on the card (a tree whose
``kernels/quant.py`` has ``w8_cluster_ctas``): ``--clusters`` prints,
for each regime's kernel (``bm`` 16, 64, 128), the CTAs that grids with
clusters of 1..16 CTAs run at once (``cluster_ctas``: the plan's
``W8_CLUSTER_SMS``); ``--sweep`` times every split count the plan could
pick (each regime's ``bm`` at M = 16, both at 256) by profiler device
time, with the CTAs each grid launches (``sweep``). With ``--bfloat16``
both read the bf16 mode's kernels (``bm`` 16, 32, 64, 128; the sweep
takes 16 and 32 at M = 16, 64 and 128 at 256).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

SHAPES = ((2048, 2048), (2048, 5504), (5504, 2048))
PER_LAYER = {(2048, 2048): 4, (2048, 5504): 2, (5504, 2048): 1}
ROWS = (16, 256)
HBM_BYTES_PER_S, FP32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 989e12


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


def device_ms(fn, calls=10, tries=5):
    """The device time of the kernel (every CUDA kernel whose name holds
    "w8_gemm") per call, from the profiler. A window in which the profiler
    recorded fewer launches than were made is measured again."""
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
                and "w8_gemm" in evt.key]
        if sum(evt.count for evt in evts) == calls:
            break
    else:
        raise RuntimeError("w8_timing: the profiler recorded %d of %d "
                           "launches" % (sum(e.count for e in evts), calls))
    return sum(evt.self_device_time_total for evt in evts) / 1e3 / calls


def sweep(quant, gen, bf16):
    """Every split count of each shape's regime(s), forced through the C
    entry point: ``{m, k, n, bm, chunk, splits, ctas, device_ms}``."""
    import torch

    from paddle_tpu_torch import _build

    lib = quant._library()
    dtype = torch.bfloat16 if bf16 else torch.float32
    entry = lib.pt_w8_gemm_bf16 if bf16 else lib.pt_w8_gemm
    rows = []
    for k, n in SHAPES:
        w = torch.randn(k, n, generator=gen, device="cuda") * 0.02
        q, scales = quant.quantize_int8_weight(w.to(dtype))
        for m in ROWS:
            x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
            y = torch.empty(m, n, device="cuda", dtype=dtype)
            if bf16:
                bms = (16, 32) if m <= 16 else (64, 128)
            else:
                bms = ((quant.W8_SMALL_BM,) if m <= quant.W8_SMALL_M
                       else quant.W8_LARGE_BM)
            for bm in bms:
                small = bm == quant.W8_SMALL_BM
                if bf16:
                    granule, bn = quant.W8B_KT, quant.W8B_BN
                else:
                    granule = quant.W8_SMALL_KT if small else quant.W8_KT
                    bn = quant.W8_SMALL_BN if small else quant.W8_LARGE_BN
                for splits in range(1, quant.W8_MAX_CLUSTER + 1):
                    chunk = -(-k // (splits * granule)) * granule
                    if -(-k // chunk) != splits:
                        continue

                    def kernel(bm=bm, chunk=chunk, splits=splits):
                        _build.check(lib, entry(
                            x.data_ptr(), q.data_ptr(), scales.data_ptr(),
                            y.data_ptr(), m, n, k, k // scales.shape[0], bm,
                            chunk, splits, _build.stream_handle(x.device)),
                            "w8_timing sweep")

                    try:
                        ms = device_ms(kernel)
                    except RuntimeError as err:
                        raise RuntimeError("%s (m %d, k %d, n %d, bm %d, "
                                           "splits %d)" % (err, m, k, n, bm,
                                                           splits)) from err
                    rows.append(dict(
                        m=m, k=k, n=n, bm=bm, chunk=chunk, splits=splits,
                        ctas=splits * -(-n // bn) * -(-m // bm),
                        device_ms=ms))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?",
                    default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bfloat16", action="store_true",
                    help="time the bf16 mode (bf16 x and y)")
    ap.add_argument("--sweep", action="store_true",
                    help="time every split count of each shape")
    ap.add_argument("--clusters", action="store_true",
                    help="the CTAs a grid of each cluster size runs at once")
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
    bf16 = args.bfloat16
    dtype, esize = (torch.bfloat16, 2) if bf16 else (torch.float32, 4)
    plan = getattr(quant, "w8_plan_bf16", quant.w8_plan) if bf16 \
        else quant.w8_plan
    out = {"root": root, "device": torch.cuda.get_device_name(0),
           "power_limit": power.stdout.strip().splitlines()[0],
           "dtype": str(dtype).split(".")[-1], "rows": []}
    for k, n in SHAPES:
        w = torch.randn(k, n, generator=gen, device="cuda") * 0.02
        q, scales = quant.quantize_int8_weight(w.to(dtype))
        deq = quant.dequantize_int8_weight(q, scales, dtype)
        for m in ROWS:
            x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
            nbytes = (q.numel() + scales.numel() * 4
                      + (m * k + m * n) * esize)

            def kernel():
                return quant.int8_weight_matmul(x, q, scales)

            row = {
                "m": m, "k": k, "n": n, "plan": list(plan(m, n, k)),
                "ms": time_ms(kernel),
                "device_ms": device_ms(kernel),
                "plain_ms": time_ms(
                    lambda: quant.int8_weight_matmul_reference(x, q,
                                                               scales)),
                "matmul_dequantized_ms": time_ms(lambda: torch.matmul(x,
                                                                      deq)),
                "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                                2 * m * n * k / (BF16_FLOPS if bf16
                                                 else FP32_FLOPS)) * 1e3}
            if not bf16:
                row["matmul_fp32_ms"] = time_ms(lambda: torch.matmul(x, w))
            out["rows"].append(row)
    if args.clusters:
        bms = quant.W8B_BM if bf16 else (quant.W8_SMALL_BM, 64, 128)
        out["cluster_ctas"] = {
            str(bm): [quant.w8_cluster_ctas(bm, c, **(
                {"bf16": True} if bf16 else {}))
                for c in range(1, quant.W8_MAX_CLUSTER + 1)]
            for bm in bms}
    if args.sweep:
        out["sweep"] = sweep(quant, gen, bf16)
    keys = ("ms", "device_ms", "plain_ms", "matmul_dequantized_ms",
            "bound_ms") + (() if bf16 else ("matmul_fp32_ms",))
    out["layers"] = [
        dict(m=m, **{key: sum(PER_LAYER[(r["k"], r["n"])] * r[key]
                              for r in out["rows"] if r["m"] == m)
                     for key in keys})
        for m in ROWS]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
