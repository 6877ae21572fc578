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

The engine owns the paged KV cache; the model sees one view per layer
through its external-cache hook. The pools are updated in place. Greedy
decoding (argmax) only, which is what lets the tests hold the port's
tokens equal to the reference engine's.

Not in this slice: weight-only int8 decode, fault injection, poison
quarantine, deadlines and load shedding, record/replay, and the monitor
and memory planes.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core import flags
from ..device import resolve_device
from .kv_cache import (PagedDecodeView, PagedKVCache, PagedMixedView,
                       PagedPrefillView)
from .metrics import EngineMetrics, now
from .prefix_cache import RadixPrefixCache
from .scheduler import Request, RequestState, Scheduler


class Engine:
    def __init__(self, model, max_slots=4, num_blocks=64, block_size=16,
                 max_model_len=None, prefill_chunk=16, device=None):
        """``device`` defaults to the card and raises without one; the
        model's parameters must already live on that device.
        ``prefill_chunk`` is the mixed step's row width under chunked
        prefill."""
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
        """One engine iteration: admit + prefill, grow pages (reclaiming
        or preempting on exhaustion), one batched decode step, or under
        chunked prefill one mixed step. Returns has_work()."""
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
            if self.chunked_prefill:
                # the prompt streams through the mixed steps from
                # prefill_pos on; the request holds its slot in PREFILL
                self.metrics.on_prefill_run()
                continue
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
        request."""
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
                if self.scheduler.preempt_victim(
                        slot, include_prefill=self.chunked_prefill) is None:
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
        bt = torch.tensor(self.cache.block_tables, device=self.device)
        lens = torch.tensor(self.cache.seq_lens, device=self.device)
        ql = torch.tensor(q_lens, device=self.device)
        with torch.no_grad():
            views = [PagedMixedView(p, bt, lens, ql, self.block_size)
                     for p in self.cache.pools]
            logits = self.model.generate_step(
                torch.tensor(tokens, device=self.device), views, lens)
            last = logits[torch.arange(self.max_slots, device=self.device),
                          (ql.long() - 1).clamp(min=0)]
            out = last.float().argmax(dim=-1).cpu().numpy()
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

    def _accept_token(self, req, tok):
        req.generated.append(tok)
        self._slot_tokens[req.slot] = tok
        self.metrics.on_output_token()
        if req.remaining <= 0 or (req.eos_token_id is not None
                                  and tok == req.eos_token_id):
            self.scheduler.release(req)
            req.finish()
            self.metrics.on_request_finished()
