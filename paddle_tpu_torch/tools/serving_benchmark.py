"""Serving benchmark: continuous batching under Poisson arrivals (the
port of tools/serving_benchmark.py's single-engine path).

    python3 -m paddle_tpu_torch.tools.serving_benchmark \\
        [--preset tiny|llama1b] [--device cuda|cpu] [--requests N]
        [--rate R] [--prompt-len LO HI] [--max-new LO HI]
        [--max-slots S] [--num-blocks B] [--block-size BS] [--seed N]
        [--prefix-cache] [--chunked-prefill] [--prefill-chunk C]
        [--quant-kv] [--quant-weights]
        [--shared-prefix-tokens T] [--prefix-groups G]
        [--max-queue Q] [--deadline-s D]
        [--fault-rate P | --fault-schedule S] [--fault-seed N]
        [--record-out journal.jsonl] [--replay journal.jsonl]
        [--out report.json]

A seeded open-loop workload: requests arrive by a Poisson process of
``--rate`` requests a second with random prompt and output lengths, and
stream through ``serving.Engine`` (continuous batching, paged KV pages,
preemption when the pool runs dry). The arrivals, prompts and output
lengths come from ``np.random.RandomState(seed)`` in the reference's order
of draws, so one seed gives both tools the same traffic; the weights are
random from ``--seed`` (``torch.Generator``). The tier-2 switches set
``FLAGS_serving_*`` for the engine's construction only. ``--quant-kv``
keeps the byte budget of ``--num-blocks`` fp32 pages and turns it into
more int8 pages. ``--max-queue`` and ``--deadline-s`` are set on the engine
after the warm-up, and the fault schedule (``resilience/faultinject``
grammar; ``--fault-rate P`` is ``serving.prefill:error@pP``) is armed after
it, so every shed and fault lands in the measured window.

The report (printed without ``requests_detail`` as one JSON line, and
written whole to ``--out``) keeps the reference's keys where they mean the
same thing: throughput (``value``, tok/s over the window), goodput
(finished requests' tokens), TTFT/TPOT/queue p50/p90/p99, prefix-cache and
quant figures, preemptions, sheds by reason, admission rejects, faults
fired, and a row per request with its status and ``output_token_hash``.
It adds ``device``, the card's ``device_name`` and ``power_limit_w``
(``nvidia-smi``), ``warmup_s`` and ``requests_by_status``.

Eager PyTorch compiles nothing, so the reference's ``decode_compiles``,
``prefill_compiles`` and its exit-4 compile-once check have no meaning
here and are left out. The warm-up still matters: it builds every kernel
library (``nvcc``, at first use), makes cuBLAS's handles and runs one
request through the engine's prefill and decode (or mixed) path before
the measured window; its time is ``warmup_s``.

Record/replay, as in the reference tool: ``--record-out PATH`` latches
``FLAGS_serving_replay`` for the engine's construction, drops the warm-up's
entries, and after the window writes the journal of every measured request
(``serving/replay.py``) with the model meta ``ptreplay`` rebuilds from:
``{"preset", "seed", "config"}`` and ``"weights"``, which names the port's
initialisation (the preset drawn by ``torch.Generator(device)`` from
``--seed``). A ``model`` passed to ``run`` must be that model.
``--replay PATH`` runs nothing of its own: it re-drives the journal
through ``tools/ptreplay.py`` (``run_replay``) on ``--device``, writes the
divergence report to ``--out`` and exits 2 on a divergence.

Not ported: the fleet mode, and the SLO, profile, monitor and trace
outputs.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from .. import _build
from ..core import flags
from ..models import LlamaConfig, LlamaForCausalLM
from ..resilience import faultinject
from ..serving import AdmissionError, Engine, replay
from ..serving.replay import token_hash
from . import ptreplay

PRESETS = {
    # geometry only: the weights are random (throughput, not quality)
    "tiny": dict(hidden_size=64, intermediate_size=128,
                 num_hidden_layers=2, num_attention_heads=4,
                 vocab_size=256, max_position_embeddings=256),
    "llama1b": dict(hidden_size=2048, intermediate_size=5504,
                    num_hidden_layers=22, num_attention_heads=16,
                    vocab_size=32000, max_position_embeddings=2048),
}
_FLAGS = ("FLAGS_serving_prefix_cache", "FLAGS_serving_chunked_prefill",
          "FLAGS_serving_quant_kv", "FLAGS_serving_quant_weights",
          "FLAGS_serving_replay")


def _pct(values, q):
    return (float(np.percentile(np.asarray(values, dtype=float), q))
            if values else None)


def _pcts(values):
    """Aggregate percentile row (p50/p90/p99) for the JSON report."""
    return {"p50": _pct(values, 50), "p90": _pct(values, 90),
            "p99": _pct(values, 99)}


def workload(args, vocab_size):
    """``(arrivals, prompts, max_new)``: the reference's draws from
    ``np.random.RandomState(seed)``, in its order."""
    rng = np.random.RandomState(args.seed)
    arrivals = np.cumsum(rng.exponential(1.0 / args.rate, args.requests))
    lo, hi = args.prompt_len
    if args.shared_prefix_tokens > 0:
        prefixes = [rng.randint(0, vocab_size,
                                (args.shared_prefix_tokens,)).tolist()
                    for _ in range(args.prefix_groups)]
        group_of = [int(rng.randint(args.prefix_groups))
                    for _ in range(args.requests)]
        prompts = [prefixes[group_of[i]]
                   + rng.randint(0, vocab_size,
                                 (int(rng.randint(lo, hi + 1)),)).tolist()
                   for i in range(args.requests)]
    else:
        prompts = [rng.randint(0, vocab_size,
                               (int(rng.randint(lo, hi + 1)),)).tolist()
                   for _ in range(args.requests)]
    max_new = [int(rng.randint(args.max_new[0], args.max_new[1] + 1))
               for _ in range(args.requests)]
    return arrivals, prompts, max_new


def card_identity(device):
    """``(name, power limit in W)`` of a CUDA device from ``nvidia-smi``;
    ``(None, None)`` on the CPU."""
    if device.type != "cuda":
        return None, None
    smi = subprocess.run(
        ["nvidia-smi", "-i", str(device.index),
         "--query-gpu=name,power.limit", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    name, limit = (f.strip() for f in smi.stdout.strip().split(","))
    return name, float(limit)


def build_engine(model, args, num_blocks, device):
    """The engine with the tier-2 and replay flags of ``args`` set for its
    construction (they are latched there) and restored right after."""
    before = flags.get_flags(list(_FLAGS))
    flags.set_flags(dict(zip(_FLAGS, (
        bool(args.prefix_cache), bool(args.chunked_prefill),
        bool(args.quant_kv), bool(args.quant_weights),
        bool(args.record_out)))))
    try:
        return Engine(model, max_slots=args.max_slots, num_blocks=num_blocks,
                      block_size=args.block_size,
                      prefill_chunk=args.prefill_chunk, device=device)
    finally:
        flags.set_flags(before)


def run(args, model=None):
    """One benchmark run; returns the report. ``model`` reuses a llama of
    the preset's geometry already on ``args.device`` (else one is built
    from ``--seed``)."""
    device = torch.device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = LlamaConfig(**PRESETS[args.preset])
    if model is None:
        model = LlamaForCausalLM(cfg, device=device, generator=torch.Generator(
            device=device).manual_seed(args.seed))
    arrivals, prompts, max_new = workload(args, cfg.vocab_size)

    # equal byte budget (--quant-kv): --num-blocks names the fp32 pool the
    # budget affords; int8 pages with their fp32 scales buy more pages
    kv_heads = cfg.num_key_value_heads
    head_dim = cfg.hidden_size // cfg.num_attention_heads
    fp32_page_bytes = 8 * args.block_size * kv_heads * head_dim
    quant_page_bytes = 2 * args.block_size * kv_heads * (head_dim + 4)
    num_blocks = args.num_blocks
    if args.quant_kv:
        num_blocks = max(args.num_blocks, args.num_blocks * fp32_page_bytes
                         // quant_page_bytes)
    if args.record_out:
        # a fresh journal for this run, large enough that the measured
        # workload never evicts its own head
        replay.clear()
        replay.enable(capacity=max(2 * args.requests + 64, 256))
    eng = build_engine(model, args, num_blocks, device)

    # warm-up outside the window: the kernels' build and one request
    # through prefill and decode (or the mixed step); the resilience bounds
    # come after it, so a deadline or queue bound cannot touch it
    t0 = time.perf_counter()
    if device.type == "cuda":
        _build.build()
    prompt_hi = args.prompt_len[1] + args.shared_prefix_tokens
    eng.add_request([1] * min(prompt_hi, eng.max_model_len - 2),
                    max_new_tokens=2)
    eng.run()
    n_warm = 1
    if eng.prefix_cache is not None:
        # the warm prompt must not seed the measured window's cache
        eng.prefix_cache.clear()
        eng.metrics.on_prefix_stats(eng.prefix_cache.stats(),
                                    eng.cache.cow_clones)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    warmup_s = time.perf_counter() - t0
    if args.record_out:
        # the warm-up request probes shapes; the journal holds the window
        replay.drop_entries()
    base = eng.stats()    # counters up to here are the warm-up's
    eng.max_queue = args.max_queue
    eng.default_deadline_s = args.deadline_s

    fault_schedule = args.fault_schedule
    if fault_schedule is None and args.fault_rate > 0:
        fault_schedule = "serving.prefill:error@p%g" % args.fault_rate
    if fault_schedule:
        faultinject.enable(fault_schedule, seed=args.fault_seed)

    ids = []
    rejected = {}          # admission-shed reason -> count (no id)
    # pool pressure: peak page occupancy, and the occupancy going into the
    # step that first preempted or shed
    peak_occ = 0.0
    occ_at_first_pressure = None
    pressure_base = (eng.metrics.preemptions, eng.metrics.requests_shed)
    start = time.perf_counter()
    nxt = 0
    try:
        while nxt < args.requests or eng.has_work():
            now = time.perf_counter() - start
            while nxt < args.requests and arrivals[nxt] <= now:
                try:
                    ids.append(eng.add_request(prompts[nxt],
                                               max_new_tokens=max_new[nxt]))
                except AdmissionError as e:
                    rejected[e.reason] = rejected.get(e.reason, 0) + 1
                nxt += 1
            if eng.has_work():
                alloc = eng.cache.allocator
                occ = 1.0 - alloc.free_blocks / max(alloc.usable_blocks, 1)
                peak_occ = max(peak_occ, occ)
                eng.step()
                if occ_at_first_pressure is None and (
                        (eng.metrics.preemptions, eng.metrics.requests_shed)
                        != pressure_base):
                    occ_at_first_pressure = occ
            elif nxt < args.requests:
                time.sleep(min(arrivals[nxt] - now, 0.05))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - start
    finally:
        fault_state = faultinject.state() if fault_schedule else None
        if fault_schedule:
            faultinject.disable()

    stats = eng.stats()
    meas_steps = stats["decode_steps"] - base["decode_steps"]
    occ_sum = (stats["slot_occupancy"] * stats["decode_steps"]
               - base["slot_occupancy"] * base["decode_steps"])
    per_req = []
    for r in ids:
        row = dict(eng.request_metrics(r), request_id=r)
        status = eng.request_status(r)
        row["status"] = status["state"]
        if status["reason"] is not None:
            row["status_reason"] = status["reason"]
        if status["error"] is not None:
            row["error"] = status["error"]
        row["output_token_hash"] = token_hash(eng.output(r))
        per_req.append(row)
    by_status = {}
    for m in per_req:
        by_status[m["status"]] = by_status.get(m["status"], 0) + 1
    ttft = [m["ttft_s"] for m in per_req if m["ttft_s"] is not None]
    tpot = [m["tpot_s"] for m in per_req if m["tpot_s"] is not None]
    queue = [m["queue_time_s"] for m in per_req
             if m["queue_time_s"] is not None]
    out_tokens = sum(m["output_tokens"] for m in per_req)
    # TTFT by the prefix-cache outcome of the FIRST admission
    ttft_hit = [m["ttft_s"] for m in per_req if m["ttft_s"] is not None
                and m["prefix_cached_tokens_first"] > 0]
    ttft_miss = [m["ttft_s"] for m in per_req if m["ttft_s"] is not None
                 and m["prefix_cached_tokens_first"] == 0]
    name, power = card_identity(device)
    journal = None
    if args.record_out:
        replay.note_model({"preset": args.preset, "seed": args.seed,
                           "config": dict(PRESETS[args.preset]),
                           "weights": ptreplay.weights_meta(device)})
        head, entries = replay.write_journal(args.record_out)
        replay.disable()
        journal = {"path": args.record_out, "entries": len(entries),
                   "evictions": head["evictions"]}
    return {
        "kind": "serving_bench",
        "metric": "serving_throughput_tok_s",
        "value": round(out_tokens / max(wall, 1e-9), 1),
        "unit": "tok/s",
        "device": str(device),
        "device_name": name,
        "power_limit_w": power,
        "preset": args.preset,
        "workload": {
            "requests": args.requests, "poisson_rate": args.rate,
            "prompt_len": list(args.prompt_len),
            "max_new": list(args.max_new), "seed": args.seed,
            "max_slots": args.max_slots, "num_blocks": args.num_blocks,
            "block_size": args.block_size,
            "shared_prefix_tokens": args.shared_prefix_tokens,
            "prefix_groups": (args.prefix_groups
                              if args.shared_prefix_tokens else 0),
            "prefix_cache": bool(args.prefix_cache),
            "chunked_prefill": bool(args.chunked_prefill),
            "prefill_chunk": (args.prefill_chunk
                              if args.chunked_prefill else None),
            "quant_kv": bool(args.quant_kv),
            "quant_weights": bool(args.quant_weights),
        },
        "wall_s": round(wall, 3),
        "warmup_s": round(warmup_s, 3),
        "output_tokens": out_tokens,
        "ttft_s": _pcts(ttft),
        "ttft_hit_s": _pcts(ttft_hit),
        "ttft_miss_s": _pcts(ttft_miss),
        "prefix_cache_hits": len(ttft_hit),
        "prefix_cache_hit_tokens_total": (stats["prefix_hit_tokens"]
                                          - base["prefix_hit_tokens"]),
        "prefix_cache_lookup_tokens_total": (
            stats["prefix_lookup_tokens"] - base["prefix_lookup_tokens"]),
        "prefix_cache_evictions": (stats["prefix_evictions"]
                                   - base["prefix_evictions"]),
        "cow_clones": stats["cow_clones"] - base["cow_clones"],
        "prefill_chunks": stats["prefill_chunks"] - base["prefill_chunks"],
        "tpot_s": _pcts(tpot),
        "queue_time_s": _pcts(queue),
        "quant": {
            "quant_kv": bool(args.quant_kv),
            "quant_weights": bool(args.quant_weights),
            "num_blocks_fp32_budget": args.num_blocks,
            "num_blocks_effective": num_blocks,
            "kv_page_bytes_fp32": fp32_page_bytes,
            "kv_page_bytes_quant": quant_page_bytes,
            "kv_capacity_headroom_vs_fp32": round(
                num_blocks / args.num_blocks, 3),
            "peak_kv_page_occupancy": round(peak_occ, 4),
            "occupancy_before_first_pressure": (
                None if occ_at_first_pressure is None
                else round(occ_at_first_pressure, 4)),
            "shed_rate": round(
                stats["requests_shed"] / max(args.requests, 1), 4),
            "kv_quant_pages": stats["kv_quant_pages"],
            "quant_dequant_bytes": stats["quant_dequant_bytes"],
        },
        "preemptions": stats["preemptions"] - base["preemptions"],
        "decode_steps": meas_steps,
        "slot_occupancy": round(occ_sum / meas_steps if meas_steps else 0.0,
                                4),
        "requests_finished": stats["requests_finished"] - n_warm,
        "goodput_tok_s": round(
            sum(m["output_tokens"] for m in per_req
                if m["status"] == "finished") / max(wall, 1e-9), 1),
        "requests_shed_total": stats["requests_shed"],
        "shed_by_reason": stats["shed_by_reason"],
        "requests_by_status": by_status,
        "rejected_at_admission": rejected,
        "fault_schedule": fault_schedule,
        "faults_injected": (
            None if fault_state is None else
            {r["rule"]: r["fired"] for r in fault_state["rules"]}),
        "measured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "replay_journal": journal,
        "requests_detail": per_req,
    }


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=sorted(PRESETS), default="tiny")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the plain path)")
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--rate", type=float, default=10.0,
                    help="Poisson arrival rate, requests/second")
    ap.add_argument("--prompt-len", type=int, nargs=2, default=(4, 24),
                    metavar=("LO", "HI"))
    ap.add_argument("--max-new", type=int, nargs=2, default=(4, 16),
                    metavar=("LO", "HI"))
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--num-blocks", type=int, default=128)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="write the whole report (with requests_detail) "
                         "to this JSON path")
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help="probability of an injected per-request prefill "
                         "error (the poison path); 0 = injection off")
    ap.add_argument("--fault-schedule", default=None,
                    help="raw fault schedule (resilience/faultinject "
                         "grammar, overrides --fault-rate)")
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request queue TTL: still waiting past this "
                         "-> terminal 'expired'")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bounded admission queue: arrivals beyond it are "
                         "shed (counted, not enqueued)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="FLAGS_serving_prefix_cache")
    ap.add_argument("--chunked-prefill", action="store_true",
                    help="FLAGS_serving_chunked_prefill")
    ap.add_argument("--prefill-chunk", type=int, default=16,
                    help="chunk size for --chunked-prefill")
    ap.add_argument("--quant-kv", action="store_true",
                    help="FLAGS_serving_quant_kv, at --num-blocks fp32 "
                         "pages' bytes")
    ap.add_argument("--quant-weights", action="store_true",
                    help="FLAGS_serving_quant_weights (int8 projection "
                         "weights on the decode and mixed steps)")
    ap.add_argument("--shared-prefix-tokens", type=int, default=0,
                    help="every prompt starts with one of --prefix-groups "
                         "shared prefixes of this many tokens")
    ap.add_argument("--prefix-groups", type=int, default=4)
    ap.add_argument("--record-out", default=None,
                    help="FLAGS_serving_replay: journal every measured "
                         "request (prompt ids, flags, weights generation, "
                         "output token hash) to this JSONL path; ptreplay "
                         "run re-drives it and diffs token for token")
    ap.add_argument("--replay", default=None,
                    help="re-drive a --record-out journal instead of a "
                         "workload: delegates to tools/ptreplay.py on "
                         "--device, writes the divergence report to --out; "
                         "exit code 2 on a divergence")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if args.replay:
        return ptreplay.run_replay(argparse.Namespace(
            journal=args.replay, out=args.out, full=False, matrix=False,
            against=None, device=args.device))
    report = run(args)
    print(json.dumps({k: v for k, v in report.items()
                      if k != "requests_detail"}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
            f.write("\n")
        print("wrote", args.out, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
