"""Where a training step's device time goes, on one GPU.

    python3 -m paddle_tpu_torch.tools.train_profile [--seed N]
        [--fused-ce | --bench-row] [--float32]

Builds the llama1b training row (``LlamaConfig.llama1b_train()``: 953M
parameters in bfloat16, per-layer recompute, random weights from
--seed) behind ``TrainStep`` with ``AdamW(1e-4)``, on one batch of 8 x
1024 random ids and labels, takes two warm-up steps, times a third
without the profiler (``unprofiled_wall_ms``) and runs a fourth under
``torch.profiler``. With ``--fused-ce`` the row runs as the reference's
``FLAGS_fused_lm_head_ce`` configuration: the flag on and
``TrainStep(model, None, opt, labels_to_model=True)``, so the loss tail
goes through the fused lm_head + CE kernels. With ``--float32`` the row
runs at the config's default dtype, float32 (``LlamaConfig``'s default;
``chip_smoke.py`` phase 6e): SGEMMs in full float32 and the flash kernels'
float32 CUDA-core modes; with ``--fused-ce`` too, the float32 fused step
(``chip_smoke.py`` phase 6f), whose loss tail runs the fused kernels'
float32 modes. With ``--bench-row`` it
profiles the reference's own training row instead (``bench.py:70-162``
with ``BENCH_FUSE=1``: hidden 768, 12 layers, 6 heads x 128, FFN 2048,
fused QKV and gate/up projections, bf16, no recompute, 8 x 1024 per
step): one ``TrainStep.run_steps`` window of K = 10 stacked batches as
warm-up, one timed without the profiler and one under it; its numbers
are per window and, as ``per_step``, divided by K. It prints one JSON
line: the host wall time of the profiled step (or window), the summed
device kernel time, the device busy share (kernel time over the profiled
wall time; the profiler's host cost lowers it) and the kernel time by
group:

  gemm           cuBLAS/CUTLASS matrix products (forward, recompute and
                 backward)
  flash_forward  the flash-attention forward kernel (forward and
                 recompute)
  dq, dkv        the two flash-attention backward kernels
  fused_ce       the fused lm_head + CE kernels (forward, dl, dh, dW)
  loss           kernels launched inside ``train_step.loss`` and, in the
                 backward, before its first GEMM (the loss's own backward
                 runs first: the lm_head's GEMMs need its gradient)
  optimizer      kernels launched inside ``train_step.optimizer``
  other          the rest (norms, rope, activations, embedding, casts)

GEMM and flash kernels are grouped by name, the others by the
``record_function`` range (``TrainStep``'s phases) whose host time holds
their launch.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..core import flags
from ..models import LlamaConfig, LlamaForCausalLM
from ..nn import functional as F
from ..optimizer import AdamW
from ..parallel import TrainStep

BATCH, SEQ = 8, 1024
BENCH_K = 10     # steps per run_steps window (bench.py:132-162)
_GEMM_MARKS = ("gemm", "gemv", "cutlass", "nvjet", "xmma")


def _name_group(name):
    if "fce_" in name:
        return "fused_ce"
    if "flash_bwd_dq" in name:
        return "dq"
    if "flash_bwd_dkv" in name:
        return "dkv"
    if "flash_fwd" in name:
        return "flash_forward"
    if any(mark in name.lower() for mark in _GEMM_MARKS):
        return "gemm"
    return None


def _is_cuda(evt):
    return evt.device_type == torch.autograd.DeviceType.CUDA


def breakdown(prof, wall_ms):
    """Device kernel time of one profiled step, by group."""
    kernels = {}
    for evt in prof.key_averages():
        # the phase ranges also appear on the device timeline, as
        # annotations spanning their kernels: not kernels themselves
        if (_is_cuda(evt) and evt.self_device_time_total > 0
                and not evt.key.startswith("train_step.")):
            kernels[evt.key] = (evt.self_device_time_total / 1e3, evt.count)
    total = sum(ms for ms, _ in kernels.values())
    groups = dict.fromkeys(("gemm", "flash_forward", "dq", "dkv", "fused_ce",
                            "loss", "optimizer", "other"), 0.0)
    for name, (ms, _) in kernels.items():
        group = _name_group(name)
        if group is not None:
            groups[group] += ms

    # the rest by phase, from the host time of the op that launched them
    events = [e for e in prof.events() if not _is_cuda(e)]
    # each phase's host ranges, one per step of the window
    phases = {"loss": [], "backward": [], "optimizer": []}
    for e in events:
        name = e.name[len("train_step."):]
        if e.name.startswith("train_step.") and name in phases:
            phases[name].append((e.time_range.start, e.time_range.end))
    loss_ranges = list(phases["loss"])
    for bwd0, bwd1 in phases["backward"]:
        first_bwd_gemm = min(
            (e.time_range.start for e in events
             if bwd0 <= e.time_range.start < bwd1
             and any(_name_group(k.name) == "gemm" for k in e.kernels)),
            default=bwd1)
        loss_ranges.append((bwd0, first_bwd_gemm))

    def inside(t, ranges):
        return any(t0 <= t < t1 for t0, t1 in ranges)

    for e in events:
        t = e.time_range.start
        for k in e.kernels:
            if _name_group(k.name) is not None:
                continue
            if inside(t, loss_ranges):
                groups["loss"] += k.duration / 1e3
            elif inside(t, phases["optimizer"]):
                groups["optimizer"] += k.duration / 1e3
    groups["other"] = total - sum(groups.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    return {"wall_ms": wall_ms, "device_kernel_ms": total,
            "device_busy_share": total / wall_ms,
            "groups_ms": groups,
            "top_kernels": [{"name": name[:80], "ms": ms, "calls": calls}
                            for name, (ms, calls) in top]}


def bench_row_config():
    """The reference's bench row (``bench.py:80-86``, ``BENCH_FUSE=1``),
    as ``chip_smoke.py`` phase 6c builds it."""
    return LlamaConfig(vocab_size=32000, hidden_size=768,
                       intermediate_size=2048, num_hidden_layers=12,
                       num_attention_heads=6, max_position_embeddings=2048,
                       dtype="bfloat16", fuse_attention_qkv=True,
                       fuse_mlp=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--fused-ce", action="store_true",
                      help="FLAGS_fused_lm_head_ce on, loss inside the model")
    mode.add_argument("--bench-row", action="store_true",
                      help="the reference's bench row through run_steps")
    ap.add_argument("--float32", action="store_true",
                    help="the llama1b row at its default float32 (alone or "
                         "with --fused-ce)")
    args = ap.parse_args(argv)
    if args.bench_row and args.float32:
        ap.error("--bench-row is the reference's bf16 row: no --float32")
    if not torch.cuda.is_available():
        raise SystemExit("train_profile: no CUDA device")
    dtype = "float32" if args.float32 else "bfloat16"
    cfg = (bench_row_config() if args.bench_row
           else LlamaConfig.llama1b_train(dtype=dtype))
    model = LlamaForCausalLM(
        cfg, generator=torch.Generator(device="cuda").manual_seed(args.seed))
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    if args.fused_ce:
        step = TrainStep(model, None, opt, labels_to_model=True)
    else:
        step = TrainStep(
            model, lambda logits, labels: F.cross_entropy(
                logits.reshape(-1, cfg.vocab_size), labels.reshape(-1)), opt)
    rng = np.random.default_rng(args.seed)
    shape = (BENCH_K, BATCH, SEQ) if args.bench_row else (BATCH, SEQ)
    ids, labels = (torch.from_numpy(rng.integers(
        0, cfg.vocab_size, shape)).cuda() for _ in range(2))
    run = step.run_steps if args.bench_row else step
    flags.set_flags({"FLAGS_fused_lm_head_ce": args.fused_ce})
    try:
        for _ in range(1 if args.bench_row else 2):
            run(ids, labels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(ids, labels)
        torch.cuda.synchronize()
        unprofiled_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            loss = run(ids, labels)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        flags.set_flags({"FLAGS_fused_lm_head_ce": False})
    if args.bench_row:
        window = ("1 run_steps window of %d steps, bench row (fused "
                  "QKV/MLP, hidden %d, %d layers, %d heads) bf16, %d x %d"
                  % (BENCH_K, cfg.hidden_size, cfg.num_hidden_layers,
                     cfg.num_attention_heads, BATCH, SEQ))
    else:
        window = ("1 train step, llama1b %s recompute, %d x %d%s"
                  % (dtype, BATCH, SEQ, ", fused lm_head + CE"
                     if args.fused_ce else ""))
    row = {"window": window, "loss": loss.item(),
           "unprofiled_wall_ms": unprofiled_ms,
           "device": torch.cuda.get_device_name(0)}
    row.update(breakdown(prof, wall_ms))
    if args.bench_row:
        row["per_step"] = {
            "unprofiled_wall_ms": unprofiled_ms / BENCH_K,
            "wall_ms": wall_ms / BENCH_K,
            "device_kernel_ms": row["device_kernel_ms"] / BENCH_K,
            "groups_ms": {k: v / BENCH_K
                          for k, v in row["groups_ms"].items()}}
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
