"""Continuous-batching serving engine (counterpart of
paddle_tpu/serving/engine.py with every tier-2 flag off).

Each ``step()``:
  1. admits queued requests FCFS while a slot and pages are free, and
     prefills each one alone: its (resume) prompt right-padded to a
     power-of-two bucket, K/V written through its block-table row, the
     first token taken by argmax at the last real position;
  2. makes sure every decoding slot has a page for its next position,
     preempting the most recently admitted other request (requeued for
     recompute) when the pool runs dry;
  3. runs ONE batched greedy decode step over all ``max_slots`` slots
     (idle slots write to the trash page and are ignored).

The engine owns the paged KV cache; the model sees one view per layer
through its external-cache hook. The pools are updated in place. Greedy
decoding (argmax) only, which is what lets the tests hold the port's
tokens equal to the reference engine's.

Not in this slice: fault injection, poison quarantine, deadlines and
load shedding, record/replay, the monitor and memory planes, the fleet,
and the tier-2 paths (prefix cache, chunked prefill, int8 KV and
weight-only quantized decode).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..device import resolve_device
from .kv_cache import PagedDecodeView, PagedKVCache, PagedPrefillView
from .metrics import EngineMetrics, now
from .scheduler import Request, RequestState, Scheduler


class Engine:
    def __init__(self, model, max_slots=4, num_blocks=64, block_size=16,
                 max_model_len=None, device=None):
        """``device`` defaults to the card and raises without one; the
        model's parameters must already live on that device."""
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError("Engine on %s got a model on %s"
                             % (self.device, model.device))
        self.model = model
        spec = model.paged_cache_spec()
        limit = model.max_decode_len()
        if max_model_len is None:
            max_model_len = limit
        if max_model_len is None:
            raise ValueError("max_model_len required for an unbounded model")
        if limit is not None:
            max_model_len = min(max_model_len, limit)
        self.max_slots = max_slots
        self.block_size = block_size
        self.max_model_len = max_model_len
        self.cache = PagedKVCache(
            num_layers=spec["num_layers"], num_blocks=num_blocks,
            block_size=block_size, num_kv_heads=spec["num_kv_heads"],
            head_dim=spec["head_dim"], max_slots=max_slots,
            max_blocks_per_slot=-(-max_model_len // block_size),
            device=self.device, dtype=spec["dtype"])
        self.scheduler = Scheduler(max_slots, self.cache)
        self.metrics = EngineMetrics(max_slots)
        self.requests = {}
        self._next_id = 0
        # slot_tokens[s]: the slot's last generated token, not yet written
        # to KV: the next decode step's input for that slot
        self._slot_tokens = np.zeros((max_slots,), np.int64)

    # -- public API -------------------------------------------------------

    def add_request(self, prompt, max_new_tokens=32, eos_token_id=None):
        """Queue a request and return its id. Raises ValueError for a
        request that could never run alone."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        total = len(prompt) + max_new_tokens
        if total > self.max_model_len:
            raise ValueError(
                "prompt (%d) + max_new_tokens (%d) exceeds max_model_len (%d)"
                % (len(prompt), max_new_tokens, self.max_model_len))
        if self.cache.pages_needed(total) > self.cache.allocator.usable_blocks:
            raise ValueError(
                "request needs %d pages but the pool only has %d usable "
                "blocks" % (self.cache.pages_needed(total),
                            self.cache.allocator.usable_blocks))
        req = Request(self._next_id, prompt, max_new_tokens, eos_token_id)
        self._next_id += 1
        self.requests[req.id] = req
        self.metrics.on_request_in()
        if max_new_tokens == 0:
            req.finish()
            self.metrics.on_request_finished()
            return req.id
        self.scheduler.add(req)
        return req.id

    def has_work(self):
        return self.scheduler.has_work()

    def step(self):
        """One engine iteration: admit + prefill, grow pages (preempting on
        exhaustion), one batched decode step. Returns has_work()."""
        self._admit_and_prefill()
        self._grow_or_preempt()
        active = self.scheduler.active()
        if active:
            self._decode_once(active)
        return self.has_work()

    def run(self):
        """Drain all queued work; returns {request id: generated tokens}."""
        while self.step():
            pass
        return {rid: list(r.generated) for rid, r in self.requests.items()}

    def output(self, rid):
        return list(self.requests[rid].generated)

    def request_metrics(self, rid):
        return self.requests[rid].metrics.to_dict()

    def stats(self):
        return self.metrics.to_dict()

    # -- lifecycle --------------------------------------------------------

    def _admit_and_prefill(self):
        while True:
            admitted = self.scheduler.admit_next()
            if admitted is None:
                return
            self.metrics.on_admission()
            self._prefill_request(*admitted)

    def _bucket(self, n):
        """Prefill length bucket: next power of two (>= 8), capped at
        max_model_len rounded up to a multiple of 8 AND at the block
        table's position capacity (a longer pad would write past the
        slot's last table entry)."""
        p = 8
        while p < n:
            p *= 2
        cap = min(-(-self.max_model_len // 8) * 8,
                  self.cache.max_blocks_per_slot * self.block_size)
        return min(p, max(cap, n))

    def _prefill_request(self, slot, req):
        t0 = time.perf_counter()
        tokens = req.resume_tokens
        n = len(tokens)
        ids = torch.zeros((1, self._bucket(n)), dtype=torch.long)
        ids[0, :n] = torch.tensor(tokens, dtype=torch.long)
        row = torch.tensor(self.cache.block_tables[slot], device=self.device)
        with torch.no_grad():
            views = [PagedPrefillView(p, row, self.block_size)
                     for p in self.cache.pools]
            logits = self.model.generate_step(ids.to(self.device), views, 0)
            tok = int(logits[0, n - 1].float().argmax())
        self.cache.seq_lens[slot] = n
        self.metrics.on_prefill(n, time.perf_counter() - t0)
        req.state = RequestState.DECODING
        req.metrics.on_first_token(now())
        self._accept_token(req, tok)

    def _grow_or_preempt(self):
        """Every decoding slot writes one K/V row at position seq_len this
        step: make sure its page exists, preempting the most recently
        admitted other request while the pool is dry."""
        for slot, req in self.scheduler.active():
            if self.scheduler.slots[slot] is not req:
                continue            # became a victim earlier in the loop
            while not self.cache.ensure_capacity(
                    slot, int(self.cache.seq_lens[slot]) + 1):
                if self.scheduler.preempt_victim(slot) is None:
                    raise RuntimeError(
                        "KV pool exhausted by a single request; "
                        "add_request validation should have caught this")
                self.metrics.on_preemption()

    def _decode_once(self, active):
        t0 = time.perf_counter()
        bt = torch.tensor(self.cache.block_tables, device=self.device)
        lens = torch.tensor(self.cache.seq_lens, device=self.device)
        toks = torch.tensor(self._slot_tokens, device=self.device)
        with torch.no_grad():
            views = [PagedDecodeView(p, bt, lens, self.block_size)
                     for p in self.cache.pools]
            logits = self.model.generate_step(toks[:, None], views, lens)
            out = logits[:, -1].float().argmax(dim=-1).cpu().numpy()
        self.metrics.on_decode_step(len(active), time.perf_counter() - t0)
        for slot, req in active:
            # the input token's K/V row landed at position seq_len
            self.cache.seq_lens[slot] += 1
            self._accept_token(req, int(out[slot]))

    def _accept_token(self, req, tok):
        req.generated.append(tok)
        self._slot_tokens[req.slot] = tok
        self.metrics.on_output_token()
        if req.remaining <= 0 or (req.eos_token_id is not None
                                  and tok == req.eos_token_id):
            self.scheduler.release(req)
            req.finish()
            self.metrics.on_request_finished()
