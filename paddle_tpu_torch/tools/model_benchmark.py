"""Model benchmarks: the port of tools/model_benchmark.py's rows.

    python3 -m paddle_tpu_torch.tools.model_benchmark resnet50
        [--device cuda|cpu] [--dtype bfloat16|float32] [--iters N]
        [--seed N] [--profile] [--out report.json]

``resnet50`` is the reference's ResNet-50 train row
(``tools/model_benchmark.py:73-135``): ``vision.models.resnet50`` with
1000 classes, random weights from ``--seed``, ``Momentum(0.1, 0.9)`` and
the mean ``F.cross_entropy``, one batch of inputs ``U(-1, 1)`` and labels
from ``numpy.random.RandomState(seed)``, through a one-device
``TrainStep``; 2 warm-up steps, then ``N`` steps timed as one window
that a single synchronize ends, as the reference times them. On the card
the row is the reference's chip row: batch 64 at 224 x 224 in bfloat16
(the model cast with ``.to``, its running statistics too), 20 timed
steps; ``--dtype float32`` runs the same row in float32 (TF32 off, as the
port sets it). On the CPU it is the reference's plumbing row: batch 4 at
32 x 32 in float32, 2 steps. Both layouts are measured, channel-last
(NHWC) first, as in the reference.

It prints one JSON line (and writes it to ``--out``) with the reference's
metric, ``resnet50_train_images_per_sec_per_chip``: the best layout's
images/s as ``value``, ``batch``, ``image_size``, ``layout`` and
``per_layout_images_per_sec``, and beside them each layout's mean step
ms over the window, peak memory and losses, the dtype, and the card's
name and power limit (``nvidia-smi``). Each layout's ``step_ms_each``, a
diagnostic only, is the time between events recorded on the stream
after each step (on the CPU, between host clock reads), which needs no
synchronize inside the window.

With ``--profile`` each layout also runs one more step under
``torch.profiler`` and reports its device kernel time by group, by kernel
name: ``batch_norm`` (the normalisation, its statistics and its
backward, torch's or cuDNN's), ``conv``
(cuDNN's convolution kernels, forward and both gradients, and their
layout transposes), ``pool``, ``gemm`` (the
classifier's cuBLAS products) and ``other`` (ReLU, the residual adds,
casts, the loss and the optimizer's elementwise updates), beside the
profiled step's wall time and the fifteen largest kernels.

The reference's other rows (``ernie_dp``, ``widedeep``, ``allreduce``,
``llama1b``, ``llama_int8``) and ``all`` are not ported yet (ROADMAP.md,
queue A.1) and raise.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..device import resolve_device
from ..nn import functional as F
from ..optimizer import Momentum
from ..parallel import TrainStep
from ..vision.models import resnet50
from .serving_benchmark import card_identity

METRIC = "resnet50_train_images_per_sec_per_chip"
NOT_PORTED = ("ernie_dp", "widedeep", "allreduce", "llama1b", "llama_int8",
              "all")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
WARMUP = 2


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# by kernel name, first match wins: cuDNN's own batch-norm kernels
# (``cudnn::batchnorm_*``) before its convolutions, whose layout
# transposes (``nchwToNhwc``) count as convolution
_GROUPS = (("batch_norm", ("batch_norm", "batchnorm", "welford", "bn_fw",
                           "bn_bw")),
           ("conv", ("conv", "fprop", "dgrad", "wgrad", "implicit",
                     "cudnn", "winograd", "im2col")),
           ("pool", ("pool",)),
           ("gemm", ("gemm", "gemv", "cutlass", "nvjet", "xmma")))


def kernel_group(name):
    low = name.lower()
    for group, marks in _GROUPS:
        if any(mark in low for mark in marks):
            return group
    return "other"


def profile_step(step, x, y):
    """One more step under ``torch.profiler``: device kernel ms by group,
    the step's wall ms and the fifteen largest kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(x, y)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for evt in prof.key_averages():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and evt.self_device_time_total > 0
                and not evt.key.startswith("train_step.")):
            kernels[evt.key] = evt.self_device_time_total / 1e3
    groups = dict.fromkeys([g for g, _ in _GROUPS] + ["other"], 0.0)
    for name, ms in kernels.items():
        groups[kernel_group(name)] += ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    return {"wall_ms": wall, "device_ms": sum(kernels.values()),
            "groups_ms": groups,
            "top": [[kernel_group(k), k[:120], v] for k, v in top]}


def measure_resnet50(layout, dtype, iters, device, seed=0,
                     profiled=False):
    """One layout of the row: ``{images_per_s, step_ms, step_ms_each,
    peak_mem_gb, losses}`` (and ``profile``, with ``profiled``)."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    batch, size = (64, 224) if on_card else (4, 32)
    model = resnet50(num_classes=1000, data_format=layout, device=device,
                     generator=torch.Generator(device=device).manual_seed(
                         seed))
    model.to(DTYPES[dtype])
    step = TrainStep(model, F.cross_entropy,
                     Momentum(learning_rate=0.1, momentum=0.9,
                              parameters=model.parameters()),
                     device=device)
    rng = np.random.RandomState(seed)
    shape = ((batch, 3, size, size) if layout == "NCHW"
             else (batch, size, size, 3))
    x = torch.from_numpy(rng.rand(*shape).astype(np.float32) * 2 - 1).to(
        device, DTYPES[dtype])
    y = torch.from_numpy(rng.randint(0, 1000, (batch,))).to(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    losses = [step(x, y) for _ in range(WARMUP)]
    _sync(device)

    def mark():
        if not on_card:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    marks = [mark()]
    t0 = time.perf_counter()
    for _ in range(iters):
        losses.append(step(x, y))
        marks.append(mark())
    _sync(device)
    window = time.perf_counter() - t0
    each = [(b.elapsed_time(a) if on_card else (a - b) * 1e3)
            for b, a in zip(marks, marks[1:])]
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)):
        raise FloatingPointError("resnet50 %s %s: loss %s"
                                 % (layout, dtype, losses))
    row = {"images_per_s": batch * iters / window,
           "step_ms": window / iters * 1e3,
           "step_ms_each": each,
           "batch": batch, "image_size": size,
           "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                           if on_card else None),
           "losses": losses}
    if profiled:
        row["profile"] = profile_step(step, x, y)
    return row


def bench_resnet50(device="cuda", dtype=None, iters=None, seed=0,
                   profiled=False):
    """The row's report (the JSON line's fields)."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    dtype = dtype or ("bfloat16" if on_card else "float32")
    iters = iters or (20 if on_card else 2)
    measured = {}
    for layout in ("NHWC", "NCHW"):
        measured[layout] = measure_resnet50(layout, dtype, iters, device,
                                            seed, profiled)
        if on_card:
            torch.cuda.empty_cache()
    best = max(measured, key=lambda k: measured[k]["images_per_s"])
    name, power = card_identity(device)
    return {"metric": METRIC, "value": measured[best]["images_per_s"],
            "unit": "images/s", "batch": measured[best]["batch"],
            "image_size": measured[best]["image_size"], "layout": best,
            "per_layout_images_per_sec": {
                k: v["images_per_s"] for k, v in measured.items()},
            "per_layout": measured, "dtype": dtype, "iters": iters,
            "warmup": WARMUP, "seed": seed, "device": str(device),
            "device_name": name, "power_limit_w": power,
            "measured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                         time.gmtime())}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sub", choices=("resnet50",) + NOT_PORTED)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default=None)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="one more step a layout under torch.profiler")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.sub != "resnet50":
        raise NotImplementedError(
            "model_benchmark %s: not yet ported (ROADMAP.md, queue A.1)"
            % args.sub)
    report = bench_resnet50(args.device, args.dtype, args.iters, args.seed,
                            args.profile)
    line = json.dumps(report)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
