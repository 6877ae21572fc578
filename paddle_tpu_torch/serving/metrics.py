"""Serving metrics: per-request latency breakdown and engine counters
(counterpart of paddle_tpu/serving/metrics.py, without the monitor
registry, trace spans or the perf-attribution gauges).

per request (``RequestMetrics.to_dict()``):
  queue_time_s     arrival -> first admission
  ttft_s           arrival -> first token out of prefill
  tpot_s           mean inter-token time after the first token
  e2e_s            arrival -> finished
  prompt_tokens / output_tokens / preemptions
  prefix_cached_tokens         prompt tokens served from the radix cache,
                               summed over (re-)admissions
  prefix_cached_tokens_first   the same at the first admission only (the
                               hit/miss classification)

engine (``EngineMetrics.to_dict()``):
  requests_in / requests_finished / preemptions
  requests_shed / shed_by_reason
                               requests that ended without full service
                               (expired / queue_full / draining /
                               preempt_cap / poison), in all and by reason
  finished_output_tokens       output tokens of finished requests only
  goodput_tok_s                finished_output_tokens / wall time since
                               the first admission
  prefill_runs / decode_steps / output_tokens
  prefill_tokens / prefill_s   prompt tokens prefilled (resumes included,
                               padding excluded) and host seconds spent in
                               prefill; the engine reads each prefill's
                               token back, so that time covers the device
  decode_tokens / decode_s     tokens out of batched decode steps and host
                               seconds spent in them (same read-back)
  throughput_tok_s             output tokens / wall time since the first
                               admission
  slot_occupancy               mean active slots / max_slots over decode
                               (and mixed) steps
  mixed_steps / mixed_tokens / mixed_s
                               chunked prefill: mixed ragged steps, the
                               valid tokens they ran (prompt chunks and
                               decode rows) and the host seconds spent in
                               them (each step reads its tokens back);
                               each mixed step also counts as a decode
                               step, as in the reference
  tier 2, under the reference's keys (all 0 with the flags off):
  prefix_hit_tokens / prefix_lookup_tokens   admitted lookups' cached and
                               looked-up prompt tokens
  prefix_evictions / prefix_insert_pages / prefix_cached_pages
                               radix-tree pages reclaimed, inserted, held
  cow_clones                   copy-on-write page splits
  prefill_chunks               prompt chunks run through mixed steps
  kv_quant_pages               live int8 pages at the last step
  quant_dequant_bytes          int8 page bytes the steps' attention read
"""
from __future__ import annotations

import time


def now():
    return time.monotonic()


class RequestMetrics:
    def __init__(self, arrival_t, prompt_tokens):
        self.arrival_t = arrival_t
        self.first_admit_t = None
        self.first_token_t = None
        self.finish_t = None
        self.prompt_tokens = prompt_tokens
        self.output_tokens = 0
        self.preemptions = 0
        self.prefix_lookup_tokens = 0
        self.prefix_cached_tokens = 0
        self.prefix_cached_tokens_first = None

    def on_prefix_lookup(self, lookup_tokens, hit_tokens):
        if self.prefix_cached_tokens_first is None:
            self.prefix_cached_tokens_first = int(hit_tokens)
        self.prefix_lookup_tokens += int(lookup_tokens)
        self.prefix_cached_tokens += int(hit_tokens)

    def on_admit(self, t):
        if self.first_admit_t is None:
            self.first_admit_t = t

    def on_first_token(self, t):
        if self.first_token_t is None:
            self.first_token_t = t

    def on_finish(self, t, output_tokens):
        self.finish_t = t
        self.output_tokens = output_tokens

    def to_dict(self):
        def since(t0, t1):
            return None if t0 is None or t1 is None else t1 - t0

        tpot = None
        if self.finish_t is not None and self.first_token_t is not None \
                and self.output_tokens > 1:
            tpot = ((self.finish_t - self.first_token_t)
                    / (self.output_tokens - 1))
        return {
            "queue_time_s": since(self.arrival_t, self.first_admit_t),
            "ttft_s": since(self.arrival_t, self.first_token_t),
            "tpot_s": tpot,
            "e2e_s": since(self.arrival_t, self.finish_t),
            "prompt_tokens": self.prompt_tokens,
            "output_tokens": self.output_tokens,
            "preemptions": self.preemptions,
            "prefix_cached_tokens": self.prefix_cached_tokens,
            "prefix_cached_tokens_first": (
                self.prefix_cached_tokens_first or 0),
        }


class EngineMetrics:
    def __init__(self, max_slots):
        self.max_slots = max_slots
        self.start_t = None
        self.requests_in = 0
        self.requests_finished = 0
        self.requests_shed = 0
        self.shed_by_reason = {}
        self.preemptions = 0
        self.prefill_runs = 0
        self.prefill_tokens = 0
        self.prefill_s = 0.0
        self.decode_steps = 0
        self.decode_tokens = 0
        self.decode_s = 0.0
        self.output_tokens = 0
        self.finished_output_tokens = 0
        self._occupancy_sum = 0
        self.mixed_steps = 0
        self.mixed_tokens = 0
        self.mixed_s = 0.0
        self.prefix_hit_tokens = 0
        self.prefix_lookup_tokens = 0
        self.prefix_evictions = 0
        self.prefix_insert_pages = 0
        self.prefix_cached_pages = 0
        self.cow_clones = 0
        self.prefill_chunks = 0
        self.kv_quant_pages = 0
        self.quant_dequant_bytes = 0

    def on_request_in(self):
        self.requests_in += 1

    def on_request_finished(self, output_tokens=0):
        self.requests_finished += 1
        self.finished_output_tokens += int(output_tokens)

    def on_request_shed(self, reason):
        """One request ended without full service (expired / queue_full /
        draining / preempt_cap / poison)."""
        self.requests_shed += 1
        self.shed_by_reason[reason] = self.shed_by_reason.get(reason, 0) + 1

    def on_preemption(self):
        self.preemptions += 1

    def on_admission(self):
        if self.start_t is None:
            self.start_t = now()

    def on_prefill(self, tokens, seconds):
        self.prefill_runs += 1
        self.prefill_tokens += tokens
        self.prefill_s += seconds

    def on_prefill_run(self):
        """A chunked prefill admitted: its chunks run in mixed steps."""
        self.prefill_runs += 1

    def on_prefill_chunk(self, tokens):
        self.prefill_chunks += 1
        self.prefill_tokens += tokens

    def on_decode_step(self, active_slots, seconds):
        self.decode_steps += 1
        self.decode_tokens += active_slots
        self.decode_s += seconds
        self._occupancy_sum += active_slots

    def on_mixed_step(self, rows, tokens, seconds):
        self.decode_steps += 1
        self._occupancy_sum += rows
        self.mixed_steps += 1
        self.mixed_tokens += tokens
        self.mixed_s += seconds

    def on_prefix_stats(self, pc_stats, cow_clones):
        """Snapshot of the radix cache's counters, once per engine step
        with the cache on."""
        self.prefix_hit_tokens = pc_stats["hit_tokens"]
        self.prefix_lookup_tokens = pc_stats["lookup_tokens"]
        self.prefix_evictions = pc_stats["evicted_pages"]
        self.prefix_insert_pages = pc_stats["inserted_pages"]
        self.prefix_cached_pages = pc_stats["cached_pages"]
        self.cow_clones = cow_clones

    def on_quant_step(self, pages_used, dequant_bytes):
        """Once per decode or mixed step with int8 KV pages: the live page
        count and the int8 bytes the step's attention read."""
        self.kv_quant_pages = pages_used
        self.quant_dequant_bytes += int(dequant_bytes)

    def on_output_token(self):
        self.output_tokens += 1

    def to_dict(self):
        wall = (max(now() - self.start_t, 1e-9)
                if self.start_t is not None else 0.0)
        return {
            "requests_in": self.requests_in,
            "requests_finished": self.requests_finished,
            "requests_shed": self.requests_shed,
            "shed_by_reason": dict(self.shed_by_reason),
            "preemptions": self.preemptions,
            "prefill_runs": self.prefill_runs,
            "prefill_tokens": self.prefill_tokens,
            "prefill_s": self.prefill_s,
            "decode_steps": self.decode_steps,
            "decode_tokens": self.decode_tokens,
            "decode_s": self.decode_s,
            "output_tokens": self.output_tokens,
            "finished_output_tokens": self.finished_output_tokens,
            "wall_s": wall,
            "throughput_tok_s": self.output_tokens / wall if wall else 0.0,
            "goodput_tok_s": (self.finished_output_tokens / wall
                              if wall else 0.0),
            "slot_occupancy": (self._occupancy_sum
                               / (self.decode_steps * self.max_slots)
                               if self.decode_steps else 0.0),
            "mixed_steps": self.mixed_steps,
            "mixed_tokens": self.mixed_tokens,
            "mixed_s": self.mixed_s,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefix_lookup_tokens": self.prefix_lookup_tokens,
            "prefix_evictions": self.prefix_evictions,
            "prefix_insert_pages": self.prefix_insert_pages,
            "prefix_cached_pages": self.prefix_cached_pages,
            "cow_clones": self.cow_clones,
            "prefill_chunks": self.prefill_chunks,
            "kv_quant_pages": self.kv_quant_pages,
            "quant_dequant_bytes": self.quant_dequant_bytes,
        }
