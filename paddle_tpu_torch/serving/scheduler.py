"""Request lifecycle and FCFS continuous-batching scheduler
(counterpart of paddle_tpu/serving/scheduler.py, without trace hooks).

Lifecycle: QUEUED -> PREFILL -> DECODING -> FINISHED, with
PREFILL/DECODING -> PREEMPTED when the page pool runs dry (the victim
waits at the queue front until re-admission re-prefills it). Three
terminal states end a request without full service, each with a
machine-readable ``status_reason`` (``Request.close``): EXPIRED (its
queue-TTL deadline passed while it waited), SHED (load shedding: the
preemption cap) and FAILED (poison: its own step raised).

Policies (kept simple and deterministic, so outputs are reproducible):

- Admission is strict FCFS: the queue head is admitted only when a slot
  is free AND the pool has pages for its whole (resume) prompt; nothing
  behind it jumps ahead.
- Preemption victim = the most recently admitted OTHER running request.
  Its pages are released and it is requeued at the FRONT by recompute:
  its resume prompt is ``prompt + generated so far``, so greedy decoding
  continues token-identically after the re-prefill.
- A finished or preempted slot is reusable at once; admission claims the
  lowest free slot index.

Serving tier 2 (latched at Engine construction): with the prefix cache
the admission check charges only the UNCACHED SUFFIX of the resume
prompt (matched pages are adopted shared from the radix tree, and an LRU
reclaim of cold cached pages runs before admission gives up); release
inserts the slot's full pages into the tree before it decrefs. With
chunked prefill, PREFILL is a resumable state (``prefill_pos`` walks the
prompt in chunks through the mixed step) and mid-prefill rows are
preemption candidates like decode rows.
"""
from __future__ import annotations

import itertools
from collections import deque
from enum import Enum

from .metrics import RequestMetrics, now


class RequestState(Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODING = "decoding"
    PREEMPTED = "preempted"
    FINISHED = "finished"
    EXPIRED = "expired"      # queue-TTL deadline passed while waiting
    SHED = "shed"            # load shed (the preemption cap)
    FAILED = "failed"        # poison: its own step raised; engine lives


class Request:
    def __init__(self, rid, prompt, max_new_tokens, eos_token_id=None,
                 deadline_s=None):
        self.id = rid
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.state = RequestState.QUEUED
        self.generated = []
        self.slot = None
        self.admit_seq = None      # monotone admission stamp (victim pick)
        self.metrics = RequestMetrics(now(), len(self.prompt))
        # queue-TTL deadline (monotonic, absolute): a request still WAITING
        # (queued or preempted) past it is closed EXPIRED; once admitted it
        # runs to its end
        self.deadline_t = (None if deadline_s is None
                           else self.metrics.arrival_t + float(deadline_s))
        self.status_reason = None  # terminal detail of EXPIRED/SHED/FAILED
        self.error = None          # the exception of a FAILED request
        # prefix cache / chunked prefill (0 and unused with the flags off),
        # both reset at every (re-)admission: cached_tokens = tokens of the
        # resume prompt served from the radix cache (prefill starts there);
        # prefill_pos = tokens of resume_tokens already run through the
        # mixed step
        self.cached_tokens = 0
        self.prefill_pos = 0

    @property
    def resume_tokens(self):
        """Context to (re-)prefill: the prompt plus everything generated."""
        return self.prompt + self.generated

    @property
    def remaining(self):
        return self.max_new_tokens - len(self.generated)

    def finish(self):
        self.state = RequestState.FINISHED
        self.metrics.on_finish(now(), len(self.generated))

    def close(self, state, reason, error=None):
        """Terminal close for EXPIRED / SHED / FAILED: stamps the finish
        time and the output count; the latency figures of such a request
        are not service latencies."""
        self.state = state
        self.status_reason = reason
        self.error = error
        self.metrics.finish_t = now()
        self.metrics.output_tokens = len(self.generated)


class Scheduler:
    def __init__(self, max_slots, cache, prefix_cache=None):
        self.cache = cache
        # radix prefix cache (FLAGS_serving_prefix_cache), or None
        self.prefix_cache = prefix_cache
        self.queue = deque()
        self.slots = [None] * max_slots    # slot -> Request or None
        self._admit_counter = itertools.count()

    def add(self, req):
        self.queue.append(req)

    def requeue_front(self, req):
        self.queue.appendleft(req)

    def expire_waiting(self):
        """Remove the waiting requests (QUEUED or PREEMPTED: they hold no
        slot) whose deadline passed and return them, oldest first, for the
        engine to close EXPIRED. Admitted requests are never expired."""
        t = now()
        expired = [r for r in self.queue
                   if r.deadline_t is not None and t >= r.deadline_t]
        if expired:
            dead = set(map(id, expired))
            self.queue = deque(r for r in self.queue if id(r) not in dead)
        return expired

    def has_work(self):
        return bool(self.queue) or any(r is not None for r in self.slots)

    def active(self):
        """(slot, req) for the slots currently decoding, in slot order."""
        return [(i, r) for i, r in enumerate(self.slots)
                if r is not None and r.state is RequestState.DECODING]

    def occupied(self):
        """(slot, req) for every slot holding live work: DECODING rows
        plus mid-prefill chunk rows (chunked prefill keeps the PREFILL
        state across steps), in slot order."""
        return [(i, r) for i, r in enumerate(self.slots)
                if r is not None and r.state in (RequestState.PREFILL,
                                                 RequestState.DECODING)]

    def slots_active(self):
        """Occupied slot count, any state."""
        return sum(1 for r in self.slots if r is not None)

    def admit_next(self):
        """Admit the queue head if a slot is free and the pool can hold
        its resume prompt's uncached suffix (the whole prompt without the
        prefix cache). Returns (slot, req) or None. With the prefix cache
        the head's prefix is matched first; matched pages are adopted
        shared instead of allocated, and when even the suffix does not
        fit, an LRU reclaim of unreferenced cached pages runs before
        giving up."""
        if not self.queue:
            return None
        free = [i for i, r in enumerate(self.slots) if r is None]
        if not free:
            return None
        req = self.queue[0]
        slot = free[0]
        tokens = req.resume_tokens
        matched_pages, matched = [], 0
        if self.prefix_cache is not None:
            matched_pages, matched = self.prefix_cache.match(
                tokens, limit=len(tokens) - 1)
        need = self.cache.pages_needed(len(tokens)) - len(matched_pages)
        if matched % self.cache.block_size:
            # the partially matched page is cloned at its first write:
            # charge the clone now, so the admission stays all-or-nothing
            need += 1
        # adopt BEFORE any reclaim: the slot's reference protects the
        # just-matched pages from this admission's own LRU walk
        if matched_pages:
            self.cache.adopt_prefix(slot, matched_pages, matched)
        if need > self.cache.allocator.free_blocks:
            if self.prefix_cache is not None:
                self.prefix_cache.reclaim(
                    need - self.cache.allocator.free_blocks)
            if need > self.cache.allocator.free_blocks:
                if matched_pages:       # undo: all-or-nothing admission
                    self.cache.release_slot(slot)
                return None
        self.queue.popleft()
        if not self.cache.ensure_capacity(slot, len(tokens)):
            raise AssertionError("admission raced the allocator")
        req.cached_tokens = matched
        req.prefill_pos = matched
        if self.prefix_cache is not None:
            self.prefix_cache.note_lookup(len(tokens), matched)
            req.metrics.on_prefix_lookup(len(tokens), matched)
        self.slots[slot] = req
        req.slot = slot
        req.state = RequestState.PREFILL
        req.admit_seq = next(self._admit_counter)
        req.metrics.on_admit(now())
        return slot, req

    def release(self, req):
        """Release the request's slot and pages (finish or preempt). With
        the prefix cache the slot's full pages are inserted into the tree
        first, so the computed history (prompt and generated tokens) stays
        warm for a resume or the next request sharing the prompt head."""
        slot = req.slot
        if self.prefix_cache is not None:
            self.prefix_cache.insert(req.resume_tokens,
                                     self.cache.slot_pages(slot),
                                     int(self.cache.seq_lens[slot]))
        self.cache.release_slot(slot)
        self.slots[slot] = None
        req.slot = None

    def preempt_victim(self, exclude_slot, max_preemptions=None,
                       include_prefill=False):
        """Preempt the most recently admitted running request other than
        ``exclude_slot`` and requeue it at the front. Returns the victim,
        or None when no other candidate is eligible. With
        ``max_preemptions`` set, a request preempted that many times is no
        longer a candidate: it runs to its end, which breaks the
        preempt-recompute livelock. ``include_prefill`` widens the
        candidates to mid-prefill chunk rows (chunked prefill); without it
        only decoding requests are candidates."""
        pool = self.occupied() if include_prefill else self.active()
        candidates = [r for i, r in pool if i != exclude_slot
                      and (max_preemptions is None
                           or r.metrics.preemptions < max_preemptions)]
        if not candidates:
            return None
        victim = max(candidates, key=lambda r: r.admit_seq)
        self.release(victim)
        victim.state = RequestState.PREEMPTED
        victim.metrics.preemptions += 1
        self.requeue_front(victim)
        return victim
