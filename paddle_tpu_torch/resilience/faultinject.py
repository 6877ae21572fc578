"""Deterministic fault injection: seeded, schedule-driven chaos (the
port's own copy of paddle_tpu/resilience/faultinject.py).

Named **injection sites** in the instrumented code fire faults on a
seeded schedule, so a chaos test replays the same incident every run.
One schedule and one seed fire at the same calls here as in the
reference: the grammar, the per-rule hit counting and the random stream
(``random.Random(seed)``, one draw per probabilistic rule and hit) are
the reference's.

Sites the port fires (the serving engine):

    serving.step       top of Engine.step (engine-level transient)
    serving.prefill    per-request prefill (poison-request path)
    serving.decode     batched decode / mixed step (quarantine path)

Fault kinds:

    error      raise InjectedFault at the site
    delay      sleep ``arg`` seconds (default 0.05), then proceed
    drop / broken_fd / lost_ack
               site-cooperative: returned to a caller that declared it
               can apply them (``_supports``); no port site does yet, so
               such a rule counts as ``mismatched``, never as injected

Schedule grammar (``PT_FAULT_SCHEDULE`` / ``enable(schedule)``),
semicolon-separated rules::

    site:kind[=arg][@when]

    when := N        fire on the Nth hit of the site (1-based), once
          | N..      every hit from the Nth on
          | N..M     hits N through M inclusive
          | pFLOAT   probability per hit (seeded: deterministic)
          | %N       every Nth hit
    (no @when = every hit)

Default off. ``FLAGS_fault_inject`` in the environment arms it at
import with ``PT_FAULT_SCHEDULE`` and ``PT_FAULT_SEED``. While off, every
``fire()`` is one attribute load and a branch. The reference counts fired
faults into its monitor registry; the port has no monitor plane yet and
keeps plain integer counts (``state()["injected"]``).
"""
from __future__ import annotations

import os
import random
import threading
import time

_KINDS = ("error", "delay", "drop", "broken_fd", "lost_ack")


class InjectedFault(RuntimeError):
    """A deliberately injected failure (never a real bug). Recovery code
    may match on this type; production code treats it exactly like the
    organic failure it models."""

    def __init__(self, site, rule):
        super().__init__(
            "injected fault at site %r (rule %s)" % (site, rule))
        self.site = site
        self.rule = rule


class Rule:
    """One schedule entry: fire ``kind`` at ``site`` when the site's hit
    index (1-based, counted per rule) matches ``when``."""

    __slots__ = ("site", "kind", "arg", "when", "hits", "fired",
                 "mismatched")

    def __init__(self, site, kind, arg=None, when=None):
        if kind not in _KINDS:
            raise ValueError(
                "unknown fault kind %r (one of %s)" % (kind, _KINDS))
        self.site = site
        self.kind = kind
        self.arg = arg
        self.when = when            # None | (lo, hi) | ("p", prob) | ("%", n)
        self.hits = 0
        self.fired = 0
        # matched a site that cannot apply its kind: counted here, never as
        # fired (a schedule that injects nothing must not say it did)
        self.mismatched = 0

    def _matches(self, rng):
        n = self.hits
        w = self.when
        if w is None:
            return True
        if w[0] == "p":
            return rng.random() < w[1]
        if w[0] == "%":
            return n % w[1] == 0
        lo, hi = w
        return lo <= n <= (hi if hi is not None else n)

    def __str__(self):
        arg = "=%s" % self.arg if self.arg is not None else ""
        if self.when is None:
            when = ""
        elif self.when[0] == "p":
            when = "@p%g" % self.when[1]
        elif self.when[0] == "%":
            when = "@%%%d" % self.when[1]
        else:
            lo, hi = self.when
            when = "@%d" % lo if hi == lo else (
                "@%d.." % lo if hi is None else "@%d..%d" % (lo, hi))
        return "%s:%s%s%s" % (self.site, self.kind, arg, when)


def parse_schedule(spec):
    """Schedule string -> [Rule]; raises ValueError on a bad rule (a
    schedule with a silently ignored typo would test nothing)."""
    rules = []
    for part in str(spec).split(";"):
        part = part.strip()
        if not part:
            continue
        try:
            site, _, rest = part.partition(":")
            if not site or not rest:
                raise ValueError("need site:kind")
            when = None
            if "@" in rest:
                rest, _, w = rest.partition("@")
                if w.startswith("p"):
                    when = ("p", float(w[1:]))
                elif w.startswith("%"):
                    n = int(w[1:])
                    if n < 1:
                        raise ValueError("every-Nth trigger needs N >= 1")
                    when = ("%", n)
                elif ".." in w:
                    lo, _, hi = w.partition("..")
                    when = (int(lo), int(hi) if hi else None)
                else:
                    when = (int(w), int(w))
            arg = None
            if "=" in rest:
                rest, _, a = rest.partition("=")
                arg = float(a)
            rules.append(Rule(site, rest, arg, when))
        except ValueError as e:
            raise ValueError(
                "bad fault rule %r: %s (grammar: site:kind[=arg][@when])"
                % (part, e))
    return rules


class _State:
    __slots__ = ("enabled", "rules", "seed", "rng", "lock", "site_hits",
                 "injected")

    def __init__(self):
        self.enabled = False
        self.rules = []
        self.seed = 0
        self.rng = None
        self.lock = threading.Lock()
        self.site_hits = {}
        self.injected = {}          # "site:kind" -> faults fired


_state = _State()


def enable(schedule=None, seed=None):
    """Arm the framework (process-wide). ``schedule`` is a spec string or
    a list of Rules, by default ``PT_FAULT_SCHEDULE``; ``seed`` fixes the
    probabilistic rules' random stream (default ``PT_FAULT_SEED`` or 0):
    the same seed, schedule and call sequence give the same faults."""
    if schedule is None:
        schedule = os.environ.get("PT_FAULT_SCHEDULE", "")
    rules = (list(schedule) if isinstance(schedule, (list, tuple))
             else parse_schedule(schedule))
    if seed is None:
        seed = int(os.environ.get("PT_FAULT_SEED", "0"))
    with _state.lock:
        _state.rules = rules
        _state.seed = int(seed)
        _state.rng = random.Random(int(seed))
        _state.site_hits = {}
        _state.injected = {}
        _state.enabled = True
    return rules


def disable():
    """Disarm: every ``fire()`` returns to the one-branch fast path. The
    rules' hit and fired counts stay for inspection."""
    _state.enabled = False


def is_enabled():
    return _state.enabled


def fire(site, _supports=(), **ctx):
    """Injection site hook. Returns None (no fault, or a delay already
    slept) or the cooperative kind the caller must apply. Raises
    InjectedFault for kind "error". ``_supports`` declares the cooperative
    kinds this site can apply; ``ctx`` describes the call and is unused
    (the reference's sites pass it too). Hot sites guard with
    ``is_enabled()`` so they build no arguments while off."""
    if not _state.enabled:
        return None
    return _fire(site, _supports)


def _fire(site, supports):
    action = None
    with _state.lock:
        _state.site_hits[site] = _state.site_hits.get(site, 0) + 1
        for rule in _state.rules:
            if rule.site != site:
                continue
            rule.hits += 1
            if not rule._matches(_state.rng):
                continue
            if rule.kind in ("drop", "broken_fd", "lost_ack") \
                    and rule.kind not in supports:
                rule.mismatched += 1
                continue
            rule.fired += 1
            key = "%s:%s" % (site, rule.kind)
            _state.injected[key] = _state.injected.get(key, 0) + 1
            action = rule
            break
    if action is None:
        return None
    if action.kind == "delay":
        time.sleep(action.arg if action.arg is not None else 0.05)
        return None
    if action.kind == "error":
        raise InjectedFault(site, str(action))
    return action.kind


def state():
    """JSON-ready snapshot: schedule, per-site hit counts, per-rule fired
    counts, and the faults fired by site and kind."""
    with _state.lock:
        return {
            "enabled": _state.enabled,
            "seed": _state.seed,
            "rules": [{"rule": str(r), "site": r.site, "kind": r.kind,
                       "hits": r.hits, "fired": r.fired,
                       "mismatched": r.mismatched}
                      for r in _state.rules],
            "site_hits": dict(_state.site_hits),
            "injected": dict(_state.injected),
        }


def _env_flag(name):
    raw = os.environ.get(name)
    return raw is not None and raw.lower() in ("1", "true", "yes", "on")


# FLAGS_fault_inject arms the framework at import: a worker process started
# with the flag and a schedule in its environment injects from its first
# site hit
if _env_flag("FLAGS_fault_inject"):
    enable()
