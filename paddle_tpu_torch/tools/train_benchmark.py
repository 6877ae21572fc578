"""Training benchmark: the reference's own training row (the port of
bench.py's train row, ``bench.py:70-162``).

    python3 -m paddle_tpu_torch.tools.train_benchmark [--fuse]
        [--preset bench|tiny] [--device cuda|cpu] [--seed N] [--k K]
        [--windows W] [--batch B] [--seq S] [--out report.json]

The ``bench`` preset is bench.py's on-chip row: a Llama of hidden 768, 12
layers, 6 heads x 128, FFN 2048, vocab 32000, in bfloat16, random weights
from ``--seed``, 8 x 1024 tokens a step, ``AdamW(1e-4)`` and the mean
cross-entropy. ``--fuse`` is ``BENCH_FUSE=1``: one fused QKV and one fused
gate/up projection a layer. ``tiny`` is its CPU smoke row
(``LlamaConfig.tiny()``, float32). ``K`` stacked batches of random ids and
labels (``np.random.default_rng(seed)``) train as ``TrainStep.run_steps``
windows: one warm-up window, then ``--windows`` timed ones (each ended by
a synchronize). Then, from the same starting state, the same K batches run
as K single calls, bench.py's one-dispatch-per-step method. Each window
trains on the same K batches again, so the window losses fall.

It prints one JSON line (and writes it to ``--out``): the median step ms
and tokens/s of each method, the peak memory of each, the first loss (the
warm-up window's first batch), the losses, the gap between the 10th call's
loss and the warm-up window's, the card's name and power limit
(``nvidia-smi``), and ``steps``, the train steps run in all (the launch
count ``chip_smoke.py`` phase 6c holds the attention kernels to).

Not ported: ``FLAGS_fused_lm_head_ce`` (``train_profile --fused-ce`` and
``chip_smoke.py`` phase 6b run that configuration), the baseline files
and the staleness discipline of bench.py's report.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from ..models import LlamaConfig, LlamaForCausalLM
from ..nn import functional as F
from ..optimizer import AdamW
from ..parallel import TrainStep
from .serving_benchmark import card_identity


def bench_config(fuse=True):
    """bench.py's on-chip row (``BENCH_FUSE=1``: ``fuse=True``)."""
    return LlamaConfig(vocab_size=32000, hidden_size=768,
                       intermediate_size=2048, num_hidden_layers=12,
                       num_attention_heads=6, max_position_embeddings=2048,
                       dtype="bfloat16", fuse_attention_qkv=fuse,
                       fuse_mlp=fuse)


PRESETS = {"bench": bench_config,
           "tiny": lambda fuse=True: LlamaConfig.tiny(
               fuse_attention_qkv=fuse, fuse_mlp=fuse)}


def lm_loss(vocab):
    def loss_fn(logits, labels):
        return F.cross_entropy(logits.reshape(-1, vocab), labels.reshape(-1))
    return loss_fn


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak_reset(device):
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak_gb(device):
    return (torch.cuda.max_memory_allocated(device) / 1e9
            if device.type == "cuda" else None)


def run(preset="bench", fuse=True, device="cuda", seed=0, k=10, windows=2,
        batch=8, seq=1024):
    """One benchmark run; returns the report."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = PRESETS[preset](fuse)

    def fresh_step():
        """The model from the seed (the same starting state each time)
        and its train step."""
        model = LlamaForCausalLM(cfg, device=device, generator=torch.Generator(
            device=device).manual_seed(seed))
        return TrainStep(model, lm_loss(cfg.vocab_size),
                         AdamW(learning_rate=1e-4,
                               parameters=model.parameters()),
                         device=device)

    step = fresh_step()
    params = sum(p.numel() for p in step.model.parameters())
    rng = np.random.default_rng(seed)
    ids, labels = (torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (k, batch, seq))).to(device) for _ in range(2))
    _peak_reset(device)
    window_losses = [step.run_steps(ids, labels).item()]   # warm-up window
    times = []
    for _ in range(windows):
        t0 = time.perf_counter()
        loss = step.run_steps(ids, labels)
        _sync(device)
        times.append(time.perf_counter() - t0)
        window_losses.append(loss.item())
    window_peak = _peak_gb(device)

    # the same K batches as K calls, from the warm-up window's starting
    # state (one model at a time, so the two peaks compare)
    del step
    if device.type == "cuda":
        torch.cuda.empty_cache()
    call_step = fresh_step()
    _peak_reset(device)
    call_losses, call_times = [], []
    for i in range(k):
        t0 = time.perf_counter()
        call_losses.append(call_step(ids[i], labels[i]).item())
        _sync(device)
        call_times.append(time.perf_counter() - t0)
    call_peak = _peak_gb(device)

    window_ms = statistics.median(times) * 1e3 / k
    call_ms = statistics.median(call_times[1:] or call_times) * 1e3
    name, power = card_identity(device)
    return {
        "kind": "train_bench", "preset": preset, "fuse": bool(fuse),
        "device": str(device), "device_name": name, "power_limit_w": power,
        "dtype": cfg.dtype, "params": params, "batch": [batch, seq], "k": k,
        "seed": seed, "first_loss": call_losses[0],
        "run_steps": {"step_ms": window_ms, "window_s_each": times,
                      "tokens_per_s": batch * seq / window_ms * 1e3,
                      "peak_mem_gb": window_peak,
                      "window_losses": window_losses},
        "calls": {"step_ms": call_ms,
                  "step_ms_each": [t * 1e3 for t in call_times],
                  "tokens_per_s": batch * seq / call_ms * 1e3,
                  "peak_mem_gb": call_peak, "losses": call_losses},
        "window_vs_calls_loss_gap": abs(call_losses[-1] - window_losses[0]),
        "steps": k * (1 + windows) + k,
        "measured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=sorted(PRESETS), default="bench")
    ap.add_argument("--fuse", action="store_true",
                    help="BENCH_FUSE=1: fused QKV and gate/up projections")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--k", type=int, default=10,
                    help="train steps per run_steps window")
    ap.add_argument("--windows", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    report = run(args.preset, args.fuse, args.device, args.seed, args.k,
                 args.windows, args.batch, args.seq)
    line = json.dumps(report)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
