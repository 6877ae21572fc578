"""Request lifecycle and FCFS continuous-batching scheduler
(counterpart of paddle_tpu/serving/scheduler.py, without trace hooks,
deadlines or the prefix cache).

Lifecycle: QUEUED -> PREFILL -> DECODING -> FINISHED, with
DECODING -> PREEMPTED when the page pool runs dry (the victim waits at
the queue front until re-admission re-prefills it).

Policies (kept simple and deterministic, so outputs are reproducible):

- Admission is strict FCFS: the queue head is admitted only when a slot
  is free AND the pool has pages for its whole (resume) prompt; nothing
  behind it jumps ahead.
- Preemption victim = the most recently admitted OTHER decoding request.
  Its pages are freed and it is requeued at the FRONT by recompute: its
  resume prompt is ``prompt + generated so far``, so greedy decoding
  continues token-identically after the re-prefill.
- A finished or preempted slot is reusable at once; admission claims the
  lowest free slot index.
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


class Request:
    def __init__(self, rid, prompt, max_new_tokens, eos_token_id=None):
        self.id = rid
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.state = RequestState.QUEUED
        self.generated = []
        self.slot = None
        self.admit_seq = None      # monotone admission stamp (victim pick)
        self.metrics = RequestMetrics(now(), len(self.prompt))

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


class Scheduler:
    def __init__(self, max_slots, cache):
        self.cache = cache
        self.queue = deque()
        self.slots = [None] * max_slots    # slot -> Request or None
        self._admit_counter = itertools.count()

    def add(self, req):
        self.queue.append(req)

    def requeue_front(self, req):
        self.queue.appendleft(req)

    def has_work(self):
        return bool(self.queue) or any(r is not None for r in self.slots)

    def active(self):
        """(slot, req) for the slots currently decoding, in slot order."""
        return [(i, r) for i, r in enumerate(self.slots)
                if r is not None and r.state is RequestState.DECODING]

    def admit_next(self):
        """Admit the queue head if a slot is free and the pool can hold its
        resume prompt. Returns (slot, req) or None."""
        if not self.queue:
            return None
        free = [i for i, r in enumerate(self.slots) if r is None]
        if not free:
            return None
        req = self.queue[0]
        slot = free[0]
        tokens = req.resume_tokens
        if self.cache.pages_needed(len(tokens)) \
                > self.cache.allocator.free_blocks:
            return None
        self.queue.popleft()
        if not self.cache.ensure_capacity(slot, len(tokens)):
            raise AssertionError("admission raced the allocator")
        self.slots[slot] = req
        req.slot = slot
        req.state = RequestState.PREFILL
        req.admit_seq = next(self._admit_counter)
        req.metrics.on_admit(now())
        return slot, req

    def release(self, req):
        """Release the request's slot and pages (finish or preempt)."""
        self.cache.release_slot(req.slot)
        self.slots[req.slot] = None
        req.slot = None

    def preempt_victim(self, exclude_slot):
        """Preempt the most recently admitted decoding request other than
        ``exclude_slot`` and requeue it at the front. Returns the victim,
        or None when there is no other decoding request."""
        candidates = [r for i, r in self.active() if i != exclude_slot]
        if not candidates:
            return None
        victim = max(candidates, key=lambda r: r.admit_seq)
        self.release(victim)
        victim.state = RequestState.PREEMPTED
        victim.metrics.preemptions += 1
        self.requeue_front(victim)
        return victim
