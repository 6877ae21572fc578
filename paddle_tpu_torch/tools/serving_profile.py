"""Where the serving engine's device time goes, on one GPU.

    python3 -m paddle_tpu_torch.tools.serving_profile [--seed N] [--steps N]
        [--prefix-cache] [--chunked-prefill] [--quant-kv] [--quant-weights]
        [--prefill-chunk N] [--bfloat16]

Builds llama1b (float32, or bfloat16 with ``--bfloat16``; random weights
from --seed) behind
``serving.Engine(max_slots=16, block_size=16, num_blocks=2048,
max_model_len=2048)`` and fills all 16 slots with prompts of 128-1536
tokens. Two windows run under ``torch.profiler``: the first engine step
(16 prefills and one decode step) and then ``--steps`` decode-only steps.
For each window it prints one JSON line: the host wall time, the summed
device kernel time, the device busy share (kernel time over wall time),
and the kernels with the most device time, grouped into the serving
path's parts (paged and mixed paged attention, flash attention, the
int8-weight GEMM ``w8``, the other GEMMs, other).

The tier-2 flags switch the engine's paths as ``FLAGS_serving_*`` do
(latched at construction). With ``--prefix-cache`` the prompts are the
shared-prefix traffic of ``chip_smoke.py`` phase 4b (one of 4 shared
512-token prefixes plus a 16-512-token tail, after a warm-up request per
prefix), so the first window's prefills are suffix prefills over cached
pages. With ``--chunked-prefill`` every step is one mixed step of
``--prefill-chunk``-token rows: the first window is the first mixed step
and the second ``--steps`` more. ``--quant-kv`` makes the pages int8
(the same page count, so the bytes shrink). ``--quant-weights`` multiplies
the 7 projections a layer of every decode and mixed step through the
int8-weight GEMM (``FLAGS_serving_quant_weights``), whose kernels form the
``w8`` group (its bf16 mode's tensor-core kernels with ``--bfloat16``).
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
from ..serving import Engine

_FLAGS = ("FLAGS_serving_prefix_cache", "FLAGS_serving_chunked_prefill",
          "FLAGS_serving_quant_kv", "FLAGS_serving_quant_weights")


def _group(name):
    if "mixed_paged" in name:
        return "mixed_paged_attention"
    if "paged_decode" in name:
        return "paged_attention"
    if "flash_fwd" in name:
        return "flash_attention"
    if "w8_gemm" in name:
        return "w8"
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
    ap.add_argument("--prefix-cache", action="store_true",
                    help="FLAGS_serving_prefix_cache, shared-prefix prompts")
    ap.add_argument("--chunked-prefill", action="store_true",
                    help="FLAGS_serving_chunked_prefill: mixed steps only")
    ap.add_argument("--quant-kv", action="store_true",
                    help="FLAGS_serving_quant_kv: int8 KV pages")
    ap.add_argument("--quant-weights", action="store_true",
                    help="FLAGS_serving_quant_weights: int8 projection "
                         "weights in decode and mixed steps")
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--bfloat16", action="store_true",
                    help="serve llama1b in bfloat16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("serving_profile: no CUDA device")
    cfg = LlamaConfig.llama1b(
        dtype="bfloat16" if args.bfloat16 else "float32")
    model = LlamaForCausalLM(
        cfg, generator=torch.Generator(device="cuda").manual_seed(args.seed))
    flags.set_flags(dict(zip(_FLAGS, (args.prefix_cache,
                                      args.chunked_prefill, args.quant_kv,
                                      args.quant_weights))))
    try:
        engine = Engine(model, max_slots=16, block_size=16, num_blocks=2048,
                        max_model_len=2048, prefill_chunk=args.prefill_chunk)
    finally:
        flags.set_flags(dict.fromkeys(_FLAGS, False))
    rng = np.random.default_rng(args.seed)
    vocab = cfg.vocab_size
    # warm-up: the first cuBLAS calls of each shape are not timed; with
    # the prefix cache one request per shared prefix caches it
    prefixes = [rng.integers(0, vocab, 512).tolist() for _ in range(4)]
    for prompt in (prefixes if args.prefix_cache
                   else [rng.integers(0, vocab, 64).tolist()]):
        engine.add_request(prompt, 2)
    engine.run()
    for _ in range(16):
        if args.prefix_cache:
            prompt = (prefixes[int(rng.integers(4))]
                      + rng.integers(0, vocab,
                                     int(rng.integers(16, 513))).tolist())
        else:
            prompt = rng.integers(0, vocab,
                                  int(rng.integers(128, 1537))).tolist()
        engine.add_request(prompt, args.steps + 2)
    if args.chunked_prefill:
        first, rest = "step: 1 mixed step, 16 slots", "%d mixed steps"
    else:
        first = "step: 16 %sprefills + 1 decode" % (
            "suffix " if args.prefix_cache else "")
        rest = "%d decode steps, 16 slots"
    print(json.dumps(_window(first, engine.step)), flush=True)

    def steps():
        for _ in range(args.steps):
            engine.step()

    print(json.dumps(_window(rest % args.steps, steps)), flush=True)


if __name__ == "__main__":
    main()
