"""Serving metrics: per-request latency breakdown and engine counters
(counterpart of paddle_tpu/serving/metrics.py, without the monitor
registry or trace spans).

per request (``RequestMetrics.to_dict()``):
  queue_time_s     arrival -> first admission
  ttft_s           arrival -> first token out of prefill
  tpot_s           mean inter-token time after the first token
  e2e_s            arrival -> finished
  prompt_tokens / output_tokens / preemptions

engine (``EngineMetrics.to_dict()``):
  requests_in / requests_finished / preemptions
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
                               steps
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
        }


class EngineMetrics:
    def __init__(self, max_slots):
        self.max_slots = max_slots
        self.start_t = None
        self.requests_in = 0
        self.requests_finished = 0
        self.preemptions = 0
        self.prefill_runs = 0
        self.prefill_tokens = 0
        self.prefill_s = 0.0
        self.decode_steps = 0
        self.decode_tokens = 0
        self.decode_s = 0.0
        self.output_tokens = 0
        self._occupancy_sum = 0

    def on_request_in(self):
        self.requests_in += 1

    def on_request_finished(self):
        self.requests_finished += 1

    def on_preemption(self):
        self.preemptions += 1

    def on_admission(self):
        if self.start_t is None:
            self.start_t = now()

    def on_prefill(self, tokens, seconds):
        self.prefill_runs += 1
        self.prefill_tokens += tokens
        self.prefill_s += seconds

    def on_decode_step(self, active_slots, seconds):
        self.decode_steps += 1
        self.decode_tokens += active_slots
        self.decode_s += seconds
        self._occupancy_sum += active_slots

    def on_output_token(self):
        self.output_tokens += 1

    def to_dict(self):
        wall = (max(now() - self.start_t, 1e-9)
                if self.start_t is not None else 0.0)
        return {
            "requests_in": self.requests_in,
            "requests_finished": self.requests_finished,
            "preemptions": self.preemptions,
            "prefill_runs": self.prefill_runs,
            "prefill_tokens": self.prefill_tokens,
            "prefill_s": self.prefill_s,
            "decode_steps": self.decode_steps,
            "decode_tokens": self.decode_tokens,
            "decode_s": self.decode_s,
            "output_tokens": self.output_tokens,
            "wall_s": wall,
            "throughput_tok_s": self.output_tokens / wall if wall else 0.0,
            "slot_occupancy": (self._occupancy_sum
                               / (self.decode_steps * self.max_slots)
                               if self.decode_steps else 0.0),
        }
