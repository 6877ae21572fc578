"""Continuous-batching serving engine (counterpart of
paddle_tpu/serving/engine.py).

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

Serving tier 2, each flag LATCHED at construction (flipping it later
never changes a live engine):

- ``FLAGS_serving_prefix_cache``: a radix prefix cache over the page pool
  (``prefix_cache.py``). Admission adopts the cached pages of the prompt
  head and charges only the suffix; the prefill runs only the suffix,
  over the adopted history, as a mixed step with one row
  (``_suffix_prefill``); a partially matched page is split copy-on-write
  before the first write; when the pool runs dry, cold cached pages are
  reclaimed before any request is preempted.
- ``FLAGS_serving_chunked_prefill``: no separate prefill. Prompts enter
  ``prefill_chunk`` tokens at a time as rows of ONE mixed ragged step
  ``[max_slots, prefill_chunk]`` beside the decode rows (``q_len`` 1), so
  a long prompt costs the decode batch one chunk per step
  (``_mixed_once``).
- ``FLAGS_serving_quant_kv``: the page pools are int8 with fp32 scale
  planes, quantized at write time and dequantized inside the attention
  kernels.
- ``FLAGS_serving_quant_weights``: weight-only int8 decode. The 2-D
  ``weight`` of every attention and MLP projection (``_quantizable_weight``)
  is quantized once, here, with block scales along its input axis
  (``kernels/quant.py``). The decode and mixed steps run inside
  ``int8_weight_routes``, so each of those projections multiplies through
  ``int8_weight_matmul`` (``csrc/w8_gemm.cu`` on the card: 7 launches a
  layer a step); prefill and the suffix prefill keep the fp32 weights,
  which stay beside the int8 copies. The embedding, ``lm_head`` and the
  norms stay fp32.

Resilience (all off unless asked; the counterpart of the reference's):

- ``max_queue``: ``add_request`` raises ``QueueFullError`` (and counts a
  ``queue_full`` shed) once that many requests wait; after ``drain()`` it
  raises ``DrainingError``. Neither request is enqueued nor gets an id.
- ``default_deadline_s`` / ``add_request(deadline_s=...)``: a queue TTL.
  A request still waiting past it is closed EXPIRED (reason
  ``deadline``); an admitted request runs to its end.
- ``max_preemptions``: a request preempted that many times is no longer
  a victim; when no eligible victim remains, the request that needs the
  pages is shed (SHED, reason ``preempt_cap``) instead of livelocking.
- Poison quarantine and the fault sites of ``resilience/faultinject``:
  ``serving.step`` (a transient at the top of ``step()``: the iteration
  is skipped), ``serving.prefill`` (one request's prefill raised: that
  request is FAILED, reason ``poison``) and ``serving.decode`` (a batched
  decode or mixed step raised: with one row, that request is FAILED; with
  several, every row is requeued and re-admitted one at a time until the
  failing one is named).

The reference also rebuilds the pools after a failed step
(``_recover_consumed_pools``): its compiled steps donate their input
pools, so a step that fails mid-run leaves them deleted. The port writes
its pools in place and never loses them. An injected fault fires before
any write, and a step that fails after writing some layers' K/V leaves
``seq_lens`` where it was, so the rows' retry (after their re-admission)
writes the same positions again before anything reads them; with the
prefix cache, only full pages of computed tokens enter the tree.

The engine owns the paged KV cache; the model sees one view per layer
through its external-cache hook. The pools are updated in place. Greedy
decoding (argmax) only, which is what lets the tests hold the port's
tokens equal to the reference engine's.

Record/replay (``FLAGS_serving_replay``, latched at construction like
the tier-2 flags): the engine holds ``replay.recorder(self)``, None while
the flag is off, and captures each request into the journal
(``serving/replay.py``) when it is accepted (before it is queued) and at
each terminal state: finished, expired, shed and failed. With the flag
off each capture site is one ``is None`` branch. ``weights_generation``
is stamped into every entry (no weight swap exists yet, so it stays 0).

Not in this slice: the OOM site and its forensics, and the monitor, trace
and memory planes.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..core import flags
from ..device import resolve_device
from ..kernels.quant import int8_weight_routes, quantize_int8_weight
from ..resilience import faultinject as _fi
from . import replay
from .kv_cache import (PagedDecodeView, PagedKVCache, PagedMixedView,
                       PagedPrefillView)
from .metrics import EngineMetrics, now
from .prefix_cache import RadixPrefixCache
from .scheduler import Request, RequestState, Scheduler


class AdmissionError(RuntimeError):
    """A request rejected at admission (load shed): never enqueued, no id
    assigned."""

    reason = "admission"


class QueueFullError(AdmissionError):
    """The bounded admission queue is full (``max_queue``)."""

    reason = "queue_full"


class DrainingError(AdmissionError):
    """The engine is draining (``Engine.drain()``): work already accepted
    completes, new admissions are rejected."""

    reason = "draining"


# weight-only int8 decode (FLAGS_serving_quant_weights): the 2-D projection
# weights of the attention and MLP stacks, the reference's names
# (paddle_tpu/serving/engine.py); embeddings, lm_head and norms stay fp32
_QUANT_PROJ_SEGMENTS = frozenset((
    "q_proj", "k_proj", "v_proj", "o_proj", "qkv_proj",       # llama attn
    "gate_proj", "up_proj", "down_proj", "gate_up_proj",      # llama mlp
    "qkv", "proj", "fc1", "fc2",                              # gpt
))


def _quantizable_weight(name, val):
    parts = name.split(".")
    return (getattr(val, "ndim", 0) == 2 and parts[-1] == "weight"
            and any(p in _QUANT_PROJ_SEGMENTS for p in parts[:-1]))


class Engine:
    def __init__(self, model, max_slots=4, num_blocks=64, block_size=16,
                 max_model_len=None, max_queue=None,
                 default_deadline_s=None, max_preemptions=None,
                 prefill_chunk=16, device=None):
        """``device`` defaults to the card and raises without one; the
        model's parameters must already live on that device.
        ``prefill_chunk`` is the mixed step's row width under chunked
        prefill. ``max_queue``, ``default_deadline_s`` and
        ``max_preemptions`` are the resilience bounds (module docstring);
        they are plain attributes, read on every call, so a caller may set
        them after a warm-up."""
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
        self.quant_kv = bool(flags.flag("FLAGS_serving_quant_kv"))
        self.quant_weights = bool(flags.flag("FLAGS_serving_quant_weights"))
        self.chunked_prefill = bool(
            flags.flag("FLAGS_serving_chunked_prefill"))
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.cache = PagedKVCache(
            num_layers=spec["num_layers"], num_blocks=num_blocks,
            block_size=block_size, num_kv_heads=spec["num_kv_heads"],
            head_dim=spec["head_dim"], max_slots=max_slots,
            max_blocks_per_slot=-(-max_model_len // block_size),
            device=self.device, dtype=spec["dtype"], quantized=self.quant_kv)
        # int8 bytes of one page's k and v planes: the unit of
        # quant_dequant_bytes
        self._quant_page_bytes = (2 * block_size * spec["num_kv_heads"]
                                  * spec["head_dim"])
        self.prefix_cache = (RadixPrefixCache(self.cache)
                             if flags.flag("FLAGS_serving_prefix_cache")
                             else None)
        self.scheduler = Scheduler(max_slots, self.cache, self.prefix_cache)
        self.metrics = EngineMetrics(max_slots)
        self.requests = {}
        self._next_id = 0
        self.max_queue = max_queue
        self.default_deadline_s = default_deadline_s
        self.max_preemptions = max_preemptions
        self._draining = False
        # poison quarantine: ids of the requests that were rows of a failed
        # batched step, re-admitted one at a time so the next failure names
        # a single request; a member leaves at its terminal state
        self._quarantine = set()
        # weight-only int8 decode: Linear -> (q, scales), built once here
        self.quant_weight_table = {}
        if self.quant_weights:
            with torch.no_grad():
                for name, p in model.named_parameters():
                    if _quantizable_weight(name, p):
                        module = model.get_submodule(name.rpartition(".")[0])
                        self.quant_weight_table[module] = \
                            quantize_int8_weight(p)
        # slot_tokens[s]: the slot's last generated token, not yet written
        # to KV: the next decode step's input for that slot
        self._slot_tokens = np.zeros((max_slots,), np.int64)
        # stamped into every replay entry; a weight swap would bump it
        self.weights_generation = 0
        # the record/replay recorder (FLAGS_serving_replay), latched last:
        # it snapshots the latches above; None while the flag is off
        self._replay = replay.recorder(self)

    # -- public API -------------------------------------------------------

    def add_request(self, prompt, max_new_tokens=32, eos_token_id=None,
                    deadline_s=None):
        """Queue a request and return its id. Raises DrainingError or
        QueueFullError when shedding load (the request is not enqueued and
        gets no id), and ValueError for a request that could never run
        alone. ``deadline_s`` (default ``default_deadline_s``) is its
        queue TTL."""
        if self._draining:
            self.metrics.on_request_shed("draining")
            raise DrainingError("engine is draining: new admissions "
                                "rejected")
        if self.max_queue is not None \
                and len(self.scheduler.queue) >= self.max_queue:
            self.metrics.on_request_shed("queue_full")
            raise QueueFullError(
                "admission queue full (%d waiting, max_queue=%d)"
                % (len(self.scheduler.queue), self.max_queue))
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
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        req = Request(self._next_id, prompt, max_new_tokens, eos_token_id,
                      deadline_s=deadline_s)
        self._next_id += 1
        self.requests[req.id] = req
        rec = self._replay
        if rec is not None:
            rec.admit(req, deadline_s=deadline_s)
        self.metrics.on_request_in()
        if max_new_tokens == 0:
            req.finish()
            self.metrics.on_request_finished(len(req.generated))
            if rec is not None:
                rec.terminal(req)
            return req.id
        self.scheduler.add(req)
        return req.id

    def has_work(self):
        return self.scheduler.has_work()

    def step(self):
        """One engine iteration: expire waiting requests past their
        deadline, admit + prefill, grow pages (reclaiming or preempting on
        exhaustion), one batched decode step, or under chunked prefill one
        mixed step. Returns has_work()."""
        try:
            # an engine-level transient between requests: nothing owned it,
            # no request is harmed, the iteration is skipped
            if _fi.is_enabled():
                _fi.fire("serving.step")
        except _fi.InjectedFault:
            return self.has_work()
        self._expire_waiting()
        self._admit_and_prefill()
        self._grow_or_preempt()
        if self.chunked_prefill:
            rows = self.scheduler.occupied()
            if rows:
                self._mixed_once(rows)
        else:
            active = self.scheduler.active()
            if active:
                self._decode_once(active)
        if self.prefix_cache is not None:
            self.metrics.on_prefix_stats(self.prefix_cache.stats(),
                                         self.cache.cow_clones)
        return self.has_work()

    def run(self):
        """Drain all queued work; returns {request id: generated tokens}."""
        while self.step():
            pass
        return {rid: list(r.generated) for rid, r in self.requests.items()}

    @property
    def draining(self):
        return self._draining

    def drain(self):
        """Stop admitting, finish everything already accepted (the slots
        and the queue) and return the outputs. Afterwards the engine holds
        no work, every accepted request is terminal, and ``add_request``
        keeps raising DrainingError. Waiting requests still honour their
        deadlines."""
        self._draining = True
        return self.run()

    def output(self, rid):
        return list(self.requests[rid].generated)

    def request_metrics(self, rid):
        return self.requests[rid].metrics.to_dict()

    def request_status(self, rid):
        """One request's state and machine-readable reason (finished,
        expired, shed, failed, or a live state)."""
        r = self.requests[rid]
        return {"id": rid, "state": r.state.value,
                "reason": r.status_reason,
                "output_tokens": len(r.generated),
                "preemptions": r.metrics.preemptions,
                "error": repr(r.error) if r.error is not None else None}

    def stats(self):
        return self.metrics.to_dict()

    # -- lifecycle --------------------------------------------------------

    def _expire_waiting(self):
        """Queue TTL: waiting requests past their deadline are closed
        EXPIRED (shed reason ``expired``) before admission spends anything
        on them."""
        for req in self.scheduler.expire_waiting():
            req.close(RequestState.EXPIRED, "deadline")
            self._quarantine.discard(req.id)
            self.metrics.on_request_shed("expired")
            if self._replay is not None:
                self._replay.terminal(req)

    def _admit_and_prefill(self):
        while True:
            if self._quarantine and self.scheduler.slots_active() > 0:
                # a poison bisect is open: one request at a time, so a
                # failing step names a single request
                return
            admitted = self.scheduler.admit_next()
            if admitted is None:
                return
            slot, req = admitted
            self.metrics.on_admission()
            if self.chunked_prefill:
                # the prompt streams through the mixed steps from
                # prefill_pos on; the request holds its slot in PREFILL.
                # Admission is the last point a prefill fault is this one
                # request's, so the per-request site fires here
                try:
                    if _fi.is_enabled():
                        _fi.fire("serving.prefill", request=req.id,
                                 slot=slot)
                except Exception as e:      # poison: fail it, keep serving
                    self._fail_request(req, e)
                    continue
                self.metrics.on_prefill_run()
                continue
            try:
                self._prefill_request(slot, req)
            except Exception as e:  # the request's own step failed, not
                self._fail_request(req, e)      # the engine

    def _fail_request(self, req, exc):
        """Poison quarantine: one request's step raised; fail it with a
        terminal status and keep serving the others."""
        if req.slot is not None:
            self.scheduler.release(req)
        req.close(RequestState.FAILED, "poison", error=exc)
        self._quarantine.discard(req.id)
        self.metrics.on_request_shed("poison")
        if self._replay is not None:
            self._replay.terminal(req)

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
        # the per-request site: a fault here is this request's alone
        if _fi.is_enabled():
            _fi.fire("serving.prefill", request=req.id, slot=slot)
        t0 = time.perf_counter()
        tokens = req.resume_tokens
        n = len(tokens)
        if self.prefix_cache is not None:
            # only the uncached suffix runs; admission charged the clone
            # page of a partially matched page, so this cannot fail
            hist = req.cached_tokens
            if not self.cache.make_writable(slot, hist, n):
                raise AssertionError("COW clone raced the allocator")
            tok = self._suffix_prefill(slot, tokens, hist)
        else:
            hist = 0
            ids = torch.zeros((1, self._bucket(n)), dtype=torch.long)
            ids[0, :n] = torch.tensor(tokens, dtype=torch.long)
            row = torch.tensor(self.cache.block_tables[slot],
                               device=self.device)
            with torch.no_grad():
                views = [PagedPrefillView(p, row, self.block_size)
                         for p in self.cache.pools]
                logits = self.model.generate_step(ids.to(self.device), views,
                                                  0)
                tok = int(logits[0, n - 1].float().argmax())
        self.cache.seq_lens[slot] = n
        self.metrics.on_prefill(n - hist, time.perf_counter() - t0)
        if self.prefix_cache is not None:
            # publish the fresh prompt pages at once: the next queued
            # request sharing this prompt head admits against them
            self.prefix_cache.insert(tokens, self.cache.slot_pages(slot), n)
        req.state = RequestState.DECODING
        req.metrics.on_first_token(now())
        self._accept_token(req, tok)

    def _suffix_prefill(self, slot, tokens, hist):
        """The prefix-cache prefill: the uncached suffix ``tokens[hist:]``,
        right-padded to its bucket, runs at positions ``hist..`` over the
        slot's adopted pool history as a one-row mixed step (hist 0 on a
        miss). Returns the first generated token."""
        suffix = tokens[hist:]
        ls = len(suffix)
        ids = torch.zeros((1, self._bucket(ls)), dtype=torch.long)
        ids[0, :ls] = torch.tensor(suffix, dtype=torch.long)
        row = torch.tensor(self.cache.block_tables[slot:slot + 1],
                           device=self.device)
        hist_v = torch.tensor([hist], dtype=torch.int32, device=self.device)
        qlen_v = torch.tensor([ls], dtype=torch.int32, device=self.device)
        with torch.no_grad():
            views = [PagedMixedView(p, row, hist_v, qlen_v, self.block_size)
                     for p in self.cache.pools]
            logits = self.model.generate_step(ids.to(self.device), views,
                                              hist_v)
            return int(logits[0, ls - 1].float().argmax())

    def _grow_or_preempt(self):
        """Every live row writes K/V this step (a decode row one position
        at seq_len, a prefill-chunk row its next chunk): make sure the
        pages exist and, with the prefix cache, are exclusively owned
        (copy-on-write). On exhaustion: first reclaim pages only the
        prefix cache holds, then preempt the most recently admitted other
        request, and when every other request is at the preemption cap,
        shed this one."""
        rows = (self.scheduler.occupied() if self.chunked_prefill
                else self.scheduler.active())
        for slot, req in rows:
            if self.scheduler.slots[slot] is not req:
                continue            # became a victim earlier in the loop
            while True:
                start = int(self.cache.seq_lens[slot])
                if req.state is RequestState.PREFILL:
                    end = start + min(self.prefill_chunk,
                                      len(req.resume_tokens)
                                      - req.prefill_pos)
                else:
                    end = start + 1
                ok = self.cache.ensure_capacity(slot, end)
                if ok and self.prefix_cache is not None:
                    ok = self.cache.make_writable(slot, start, end)
                if ok:
                    break
                if self.prefix_cache is not None:
                    # the whole shortfall in one heap walk (+1 covers a
                    # possible clone page)
                    shortfall = max(
                        self.cache.pages_needed(end)
                        - self.cache.slot_page_count(slot) + 1
                        - self.cache.allocator.free_blocks, 1)
                    if self.prefix_cache.reclaim(shortfall):
                        continue
                victim = self.scheduler.preempt_victim(
                    slot, self.max_preemptions,
                    include_prefill=self.chunked_prefill)
                if victim is None:
                    if any(i != slot for i, _ in self.scheduler.occupied()):
                        # every other running request is at the cap: shed
                        # this grower rather than livelock the pool
                        self.scheduler.release(req)
                        req.close(RequestState.SHED, "preempt_cap")
                        self._quarantine.discard(req.id)
                        self.metrics.on_request_shed("preempt_cap")
                        if self._replay is not None:
                            self._replay.terminal(req)
                        break
                    raise RuntimeError(
                        "KV pool exhausted by a single request; "
                        "add_request validation should have caught this")
                self.metrics.on_preemption()

    def _weight_routes(self):
        """The decode and mixed steps' context: the int8 projections with
        FLAGS_serving_quant_weights latched, else nothing."""
        if self.quant_weight_table:
            return int8_weight_routes(self.quant_weight_table)
        return contextlib.nullcontext()

    def _decode_once(self, active):
        t0 = time.perf_counter()
        try:
            # the batched site: a failure is not one request's until the
            # quarantine serializes the batch
            if _fi.is_enabled():
                _fi.fire("serving.decode", batch=len(active))
            bt = torch.tensor(self.cache.block_tables, device=self.device)
            lens = torch.tensor(self.cache.seq_lens, device=self.device)
            toks = torch.tensor(self._slot_tokens, device=self.device)
            with torch.no_grad(), self._weight_routes():
                views = [PagedDecodeView(p, bt, lens, self.block_size)
                         for p in self.cache.pools]
                logits = self.model.generate_step(toks[:, None], views, lens)
                out = logits[:, -1].float().argmax(dim=-1).cpu().numpy()
        except Exception as e:      # poison quarantine (_on_decode_failure)
            self._on_decode_failure(active, e)
            return
        self.metrics.on_decode_step(len(active), time.perf_counter() - t0)
        self._note_quant_step()
        for slot, req in active:
            # the input token's K/V row landed at position seq_len
            self.cache.seq_lens[slot] += 1
            self._accept_token(req, int(out[slot]))

    def _mixed_once(self, rows):
        """ONE mixed ragged step (chunked prefill): decode rows feed their
        pending token (q_len 1), PREFILL rows their next prompt chunk
        (q_len up to prefill_chunk). Each row's next token comes from its
        last valid position; a mid-prompt row's sample is discarded, and
        the final chunk's is its first generated token."""
        t0 = time.perf_counter()
        c = self.prefill_chunk
        tokens = np.zeros((self.max_slots, c), np.int64)
        q_lens = np.zeros((self.max_slots,), np.int32)
        chunks = []
        for slot, req in rows:
            if req.state is RequestState.PREFILL:
                toks = req.resume_tokens
                n = min(c, len(toks) - req.prefill_pos)
                tokens[slot, :n] = toks[req.prefill_pos:req.prefill_pos + n]
                q_lens[slot] = n
                chunks.append(n)
            else:
                tokens[slot, 0] = self._slot_tokens[slot]
                q_lens[slot] = 1
        try:
            # the same batched site as the decode step
            if _fi.is_enabled():
                _fi.fire("serving.decode", batch=len(rows))
            bt = torch.tensor(self.cache.block_tables, device=self.device)
            lens = torch.tensor(self.cache.seq_lens, device=self.device)
            ql = torch.tensor(q_lens, device=self.device)
            with torch.no_grad(), self._weight_routes():
                views = [PagedMixedView(p, bt, lens, ql, self.block_size)
                         for p in self.cache.pools]
                logits = self.model.generate_step(
                    torch.tensor(tokens, device=self.device), views, lens)
                last = logits[torch.arange(self.max_slots,
                                           device=self.device),
                              (ql.long() - 1).clamp(min=0)]
                out = last.float().argmax(dim=-1).cpu().numpy()
        except Exception as e:
            self._on_decode_failure(rows, e)
            return
        self.metrics.on_mixed_step(len(rows), int(q_lens.sum()),
                                   time.perf_counter() - t0)
        self._note_quant_step()
        for n in chunks:
            self.metrics.on_prefill_chunk(n)
        for slot, req in rows:
            n = int(q_lens[slot])
            self.cache.seq_lens[slot] += n
            if req.state is RequestState.PREFILL:
                req.prefill_pos += n
                if req.prefill_pos < len(req.resume_tokens):
                    continue        # mid-prompt: the sample is discarded
                if self.prefix_cache is not None:
                    self.prefix_cache.insert(
                        req.resume_tokens, self.cache.slot_pages(slot),
                        int(self.cache.seq_lens[slot]))
                req.state = RequestState.DECODING
                req.metrics.on_first_token(now())
            self._accept_token(req, int(out[slot]))

    def _note_quant_step(self):
        """Int8 KV accounting, once per decode or mixed step: the live
        page count, and the int8 bytes this step's attention read (every
        live slot's history pages, k and v, every layer)."""
        if not self.quant_kv:
            return
        alloc = self.cache.allocator
        read_pages = sum(-(-int(n) // self.block_size)
                         for n in self.cache.seq_lens if n)
        self.metrics.on_quant_step(
            alloc.usable_blocks - alloc.free_blocks,
            read_pages * self._quant_page_bytes * len(self.cache.pools))

    def _on_decode_failure(self, rows, exc):
        """A batched decode or mixed step raised. With one row the poison
        is named: fail it, keep the engine. With several, requeue them all
        (preempt-by-recompute keeps their greedy tokens) and quarantine
        them: re-admitted one at a time until the set clears, so the next
        failure is one request's. Every quarantined request then runs alone
        to its end (the reference's choice: re-batching an exonerated
        request beside a still-quarantined poison would make the next
        failure unattributable again)."""
        if len(rows) == 1:
            self._fail_request(rows[0][1], exc)
            return
        for slot, req in reversed(list(rows)):
            if self.scheduler.slots[slot] is not req:
                continue
            self.scheduler.release(req)
            req.state = RequestState.PREEMPTED
            req.metrics.preemptions += 1
            self.scheduler.requeue_front(req)
            self._quarantine.add(req.id)
            self.metrics.on_preemption()

    def _accept_token(self, req, tok):
        req.generated.append(tok)
        self._slot_tokens[req.slot] = tok
        self.metrics.on_output_token()
        if req.remaining <= 0 or (req.eos_token_id is not None
                                  and tok == req.eos_token_id):
            self.scheduler.release(req)
            req.finish()
            self._quarantine.discard(req.id)    # survived its solo decode
            self.metrics.on_request_finished(len(req.generated))
            if self._replay is not None:
                self._replay.terminal(req)
