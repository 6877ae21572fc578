"""Deterministic request record/replay journal (the port's copy of
paddle_tpu/serving/replay.py).

A running engine keeps no record of what it served, so a divergence after
a flag flip or a new build (other tokens for the same request) can be
neither seen nor reproduced. This module records; the replay half is
``tools/ptreplay.py``:

1. **Recorder.** A bounded journal of served requests
   (``PT_REPLAY_CAPACITY``, finished entries evicted first). At admission
   the engine's latched recorder captures what re-execution needs: the
   prompt ids, the sampling parameters (greedy; the seed slot is where a
   sampler's seed would go), the engine's latched flags (prefix, chunked,
   quant KV, quant weights), the weights generation and, once per engine,
   its capabilities (slots, pages, chunk). At the terminal state
   (finished, expired, shed, failed) it stamps the outcome: the output
   ids and their rolling hash, the request's timings, preemptions,
   prefix-cache hit tokens and the terminal reason.
2. **Journal.** ``write_journal(path)`` writes versioned JSONL: a header
   line with a wall/monotonic clock anchor and what rebuilds the serving
   setup (``note_model``), then one line per request. ``load_journal``
   reads it back. The entry and header keys are the reference's, name for
   name, so a journal written by either package loads in the other.

Where the port lacks a plane of the reference's: counts are plain
integers (``payload()``; the reference counts into its monitor
registry), ``note_divergence`` counts by axis and opens no incident, and
entries carry ``"trace_id": None`` (the port has no trace plane).

Default off (``FLAGS_serving_replay``). While off the engine's recorder
handle is None, so every capture site is one ``is None`` branch, and this
module starts no thread.
"""
from __future__ import annotations

import json
import os
import threading
import time
import weakref

from ..core import flags as _flags

JOURNAL_VERSION = 1
DEFAULT_CAPACITY = 256          # retained request entries
_DISPATCH_CAP = 1024            # dispatch-decision ring

# the flag axes each entry snapshots and ``ptreplay run --matrix`` flips,
# one at a time, against the recorded baseline
FLAG_AXES = (
    ("prefix", "FLAGS_serving_prefix_cache"),
    ("chunked", "FLAGS_serving_chunked_prefill"),
    ("quant_kv", "FLAGS_serving_quant_kv"),
    ("quant_weights", "FLAGS_serving_quant_weights"),
)


def token_hash(tokens):
    """Rolling FNV-1a-64 over token ids, as 16 hex digits: the
    order-sensitive digest two journals compare for token identity.
    ``token_hash(a + b)`` continues where ``token_hash(a)`` stopped."""
    h = 0xcbf29ce484222325
    for t in tokens:
        h ^= int(t) & 0xFFFFFFFFFFFFFFFF
        h = (h * 0x100000001b3) & 0xFFFFFFFFFFFFFFFF
    return "%016x" % h


def _env_capacity():
    return int(os.environ.get("PT_REPLAY_CAPACITY", DEFAULT_CAPACITY)
               or DEFAULT_CAPACITY)


class _ReplayState:
    __slots__ = ("enabled", "lock", "capacity", "entries", "recorded",
                 "evictions", "divergences", "dispatches", "engines",
                 "model_meta", "next_engine")

    def __init__(self):
        self.enabled = False
        self.lock = threading.Lock()
        self.capacity = _env_capacity()
        self.entries = {}       # request id -> entry (admission order)
        self.recorded = 0
        self.evictions = 0
        self.divergences = {}   # bisected axis -> replayed requests
        self.dispatches = []    # dispatch decisions, bounded
        self.engines = {}       # engine id -> capability snapshot
        self.model_meta = None  # how to rebuild the model (note_model)
        self.next_engine = 0


_state = _ReplayState()


# -- lifecycle ---------------------------------------------------------------

def enable(capacity=None):
    """Turn the journal on (process-wide); ``capacity`` bounds later
    evictions."""
    if capacity is not None:
        _state.capacity = max(int(capacity), 1)
    _state.enabled = True
    return _state


def disable():
    """Stop recording; what was recorded stays until ``clear()``."""
    _state.enabled = False


def is_enabled():
    return _state.enabled


def clear():
    """Drop everything recorded and restore the environment's capacity."""
    with _state.lock:
        _state.entries = {}
        _state.recorded = 0
        _state.evictions = 0
        _state.divergences = {}
        _state.dispatches = []
        _state.engines = {}
        _state.model_meta = None
        _state.capacity = _env_capacity()


def drop_entries():
    """Forget the request entries and dispatch rows, keeping the engine
    snapshots and the model meta (a benchmark drops its warm-up
    requests)."""
    with _state.lock:
        _state.entries = {}
        _state.recorded = 0
        _state.evictions = 0
        _state.dispatches = []


# -- recorder ----------------------------------------------------------------

def _evict_locked():
    """Drop the oldest entries past capacity, terminal ones first; an
    all-open journal still evicts its oldest."""
    while len(_state.entries) > _state.capacity:
        victim = next((rid for rid, ent in _state.entries.items()
                       if ent["state"] != "open"), None)
        if victim is None:
            victim = next(iter(_state.entries))
        del _state.entries[victim]
        _state.evictions += 1


class _Recorder:
    """One engine's recorder handle, latched by ``Engine.__init__`` when
    FLAGS_serving_replay is on (None otherwise). The engine's flags and
    capabilities are read once here, from the engine's own latches."""

    __slots__ = ("engine_id", "flags", "caps", "_engine")

    def __init__(self, engine):
        self._engine = weakref.ref(engine)
        with _state.lock:
            self.engine_id = _state.next_engine
            _state.next_engine += 1
        self.flags = {
            "FLAGS_serving_prefix_cache": engine.prefix_cache is not None,
            "FLAGS_serving_chunked_prefill": bool(engine.chunked_prefill),
            "FLAGS_serving_quant_kv": bool(engine.quant_kv),
            "FLAGS_serving_quant_weights": bool(engine.quant_weights),
        }
        self.caps = {
            "max_slots": engine.max_slots,
            "block_size": engine.block_size,
            "num_blocks": engine.cache.allocator.num_blocks,
            "max_model_len": engine.max_model_len,
            "prefill_chunk": engine.prefill_chunk,
            "max_queue": engine.max_queue,
        }
        with _state.lock:
            _state.engines[self.engine_id] = {
                "flags": dict(self.flags), "caps": dict(self.caps)}

    def admit(self, req, deadline_s=None):
        """Admission capture, once the engine owns the request."""
        if not _state.enabled:
            return
        eng = self._engine()
        entry = {
            "id": req.id,
            "engine": self.engine_id,
            "trace_id": None,
            "admitted_wall": time.time(),
            "admitted_mono": time.monotonic(),
            "prompt": list(req.prompt),
            "max_new_tokens": req.max_new_tokens,
            "eos_token_id": req.eos_token_id,
            "deadline_s": deadline_s,
            "sampling": {"mode": "greedy", "rng_seed": None},
            "flags": self.flags,
            "weights_generation": (0 if eng is None
                                   else eng.weights_generation),
            "state": "open",
        }
        with _state.lock:
            _state.entries[req.id] = entry
            _state.recorded += 1
            _evict_locked()

    def terminal(self, req):
        """Terminal capture (finished, expired, shed or failed); a no-op
        for an entry already evicted."""
        if not _state.enabled:
            return
        m = req.metrics
        d = m.to_dict()
        with _state.lock:
            entry = _state.entries.get(req.id)
            if entry is None:
                return
            entry["state"] = req.state.value
            entry["reason"] = req.status_reason
            entry["output"] = list(req.generated)
            entry["output_token_hash"] = token_hash(req.generated)
            entry["preemptions"] = m.preemptions
            entry["prefix_cached_tokens"] = m.prefix_cached_tokens
            entry["completed_wall"] = time.time()
            entry["timings_s"] = {"queue": d["queue_time_s"],
                                  "ttft": d["ttft_s"], "tpot": d["tpot_s"],
                                  "e2e": d["e2e_s"]}


def recorder(engine):
    """The engine's latch: a live ``_Recorder`` when FLAGS_serving_replay
    is on at construction (which also turns the journal on), else None."""
    if not _flags.flag("FLAGS_serving_replay"):
        return None
    if not _state.enabled:
        enable()
    return _Recorder(engine)


# -- notes -------------------------------------------------------------------

def note_dispatch(trace_id=None, nonce=None, rank=None, endpoint=None,
                  attempt=None, outcome=None, reason=None):
    """One dispatch decision (a request sent to a replica) in a bounded
    ring; a no-op while the journal is off. The port has no fleet router
    yet, so nothing of its own calls this."""
    if not _state.enabled:
        return
    rec = {"trace_id": trace_id, "nonce": nonce, "rank": rank,
           "endpoint": endpoint, "attempt": attempt, "outcome": outcome,
           "reason": reason, "wall": time.time()}
    with _state.lock:
        _state.dispatches.append(rec)
        del _state.dispatches[:-_DISPATCH_CAP]


def note_model(meta):
    """Record how to rebuild the model (preset, init seed, config kwargs);
    ``tools/ptreplay.py`` rebuilds from it. Merges over repeat calls."""
    if not _state.enabled:
        return
    with _state.lock:
        if _state.model_meta is None:
            _state.model_meta = {}
        _state.model_meta.update(meta)


def note_divergence(axis, count=1, report=None):
    """Count ``count`` replayed requests that diverged, by the axis the
    replay named (weights, prefix, chunked, quant_kv, quant_weights or
    unknown). ``report`` is accepted as the reference's is; with no
    incident plane in the port nothing is opened with it."""
    with _state.lock:
        _state.divergences[axis] = _state.divergences.get(axis, 0) + count


def divergences():
    """Replayed requests that diverged so far, by axis."""
    with _state.lock:
        return dict(_state.divergences)


# -- export ------------------------------------------------------------------

def _digest_locked(entry):
    """One summary row: the entry without its token payloads."""
    out = {
        "id": entry["id"],
        "trace_id": entry["trace_id"],
        "state": entry["state"],
        "prompt_tokens": len(entry["prompt"]),
        "max_new_tokens": entry["max_new_tokens"],
        "weights_generation": entry["weights_generation"],
        "flags": {axis: entry["flags"][name] for axis, name in FLAG_AXES},
    }
    if entry["state"] != "open":
        out["reason"] = entry.get("reason")
        out["output_tokens"] = len(entry.get("output") or ())
        out["output_token_hash"] = entry.get("output_token_hash")
        out["preemptions"] = entry.get("preemptions")
    return out


def payload():
    """The journal's summary (the reference serves it as
    ``/debugz/replay``), with the plain counts."""
    if not _state.enabled:
        return {"enabled": False, "requests": [], "dispatches": 0}
    with _state.lock:
        rows = [_digest_locked(e) for e in _state.entries.values()]
        n_disp = len(_state.dispatches)
        recent = [dict(d) for d in _state.dispatches[-16:]]
        model = (dict(_state.model_meta)
                 if _state.model_meta is not None else None)
        diverged = dict(_state.divergences)
    return {
        "enabled": True,
        "capacity": _state.capacity,
        "recorded_total": _state.recorded,
        "evictions": _state.evictions,
        "divergences": diverged,
        "entries": len(rows),
        "open": sum(1 for r in rows if r["state"] == "open"),
        "model": model,
        "requests": rows,
        "dispatches": n_disp,
        "dispatches_recent": recent,
    }


def header():
    """The journal's first line: kind, version, a clock anchor and what
    rebuilds the serving setup."""
    with _state.lock:
        engines = {str(eid): {"flags": dict(s["flags"]),
                              "caps": dict(s["caps"])}
                   for eid, s in _state.engines.items()}
        model = (dict(_state.model_meta)
                 if _state.model_meta is not None else None)
        n = len(_state.entries)
        disp = [dict(d) for d in _state.dispatches]
    return {
        "kind": "replay_journal",
        "version": JOURNAL_VERSION,
        "pid": os.getpid(),
        "written_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "clock_anchor": {"wall": time.time(), "monotonic": time.monotonic()},
        "model": model,
        "engines": engines,
        "requests": n,
        "recorded_total": _state.recorded,
        "evictions": _state.evictions,
        "dispatches": disp,
    }


def write_journal(path):
    """Write the journal as JSONL (header, then the entries in admission
    order) through a temporary file and a rename; returns (header,
    entries)."""
    head = header()
    with _state.lock:
        entries = [dict(e, flags=dict(e["flags"]))
                   for e in _state.entries.values()]
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(json.dumps(head, default=str) + "\n")
        for e in entries:
            f.write(json.dumps(e, default=str) + "\n")
    os.replace(tmp, path)
    return head, entries


def load_journal(path):
    """(header, entries) of a JSONL journal; ValueError for an empty file,
    another kind or another version."""
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    if not lines:
        raise ValueError("empty replay journal: %s" % path)
    head = json.loads(lines[0])
    if head.get("kind") != "replay_journal":
        raise ValueError("not a replay journal (kind=%r): %s"
                         % (head.get("kind"), path))
    if head.get("version") != JOURNAL_VERSION:
        raise ValueError("replay journal version %r != supported %d: %s"
                         % (head.get("version"), JOURNAL_VERSION, path))
    return head, [json.loads(ln) for ln in lines[1:]]


# a process started with FLAGS_serving_replay=1 records from its first
# engine on
if _flags.flag("FLAGS_serving_replay"):
    enable()
