"""Where the serving engine's device time goes, on one GPU.

    python3 -m paddle_tpu_torch.tools.serving_profile [--seed N] [--steps N]

Builds llama1b (float32, random weights from --seed) behind
``serving.Engine(max_slots=16, block_size=16, num_blocks=2048,
max_model_len=2048)`` and fills all 16 slots with prompts of 128-1536
tokens. Two windows run under ``torch.profiler``: the first engine step
(16 prefills and one decode step) and then ``--steps`` decode-only steps.
For each window it prints one JSON line: the host wall time, the summed
device kernel time, the device busy share (kernel time over wall time),
and the kernels with the most device time, grouped into the serving
path's parts (paged attention, flash attention, GEMMs, other).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..models import LlamaConfig, LlamaForCausalLM
from ..serving import Engine


def _group(name):
    if "paged_decode" in name:
        return "paged_attention"
    if "flash_fwd" in name:
        return "flash_attention"
    if "gemm" in name.lower() or "gemv" in name.lower():
        return "gemm"
    return "other"


def _window(label, fn):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.self_device_time_total
        if us > 0:
            kernels[evt.key] = (kernels.get(evt.key, (0.0, 0))[0] + us,
                                evt.count)
    busy_ms = sum(us for us, _ in kernels.values()) / 1e3
    groups = {}
    for name, (us, _) in kernels.items():
        groups[_group(name)] = groups.get(_group(name), 0.0) + us / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    return {"window": label, "wall_ms": wall_ms,
            "device_kernel_ms": busy_ms if kernels else None,
            "device_busy_share": busy_ms / wall_ms if kernels else None,
            "groups_ms": groups,
            "top_kernels": [{"name": name[:80], "ms": us / 1e3,
                             "calls": calls}
                            for name, (us, calls) in top]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("serving_profile: no CUDA device")
    cfg = LlamaConfig.llama1b()
    model = LlamaForCausalLM(
        cfg, generator=torch.Generator(device="cuda").manual_seed(args.seed))
    engine = Engine(model, max_slots=16, block_size=16, num_blocks=2048,
                    max_model_len=2048)
    rng = np.random.default_rng(args.seed)
    # warm-up request: the first cuBLAS calls of each shape are not timed
    engine.add_request(rng.integers(0, cfg.vocab_size, 64).tolist(), 2)
    engine.run()
    for n in rng.integers(128, 1537, 16):
        engine.add_request(rng.integers(0, cfg.vocab_size, n).tolist(),
                           args.steps + 2)
    print(json.dumps(_window("step: 16 prefills + 1 decode", engine.step)),
          flush=True)

    def decode_steps():
        for _ in range(args.steps):
            engine.step()

    print(json.dumps(_window("%d decode steps, 16 slots" % args.steps,
                             decode_steps)), flush=True)


if __name__ == "__main__":
    main()
