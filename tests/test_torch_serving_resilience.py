"""The port's serving engine against the JAX engine on its resilience
paths: the bounded admission queue, deadline expiry, the preemption cap,
drain, poison prefills and the decode quarantine, all driven by the same
fault schedules (each package's own ``resilience.faultinject``, the same
seed), with every tier-2 flag off and with prefix cache + chunked
prefill.

Both engines get the same weights (copied through ``load_jax_state``)
and the same requests; the port runs on the CPU (``device="cpu"``). Each
scenario must give the same statuses, reasons, errors, output tokens,
shed counts by reason, goodput count and fault-site hits in both. Request
ids are compared by position (the reference numbers its requests from a
process-wide counter).

The last test is the port's own: a decode or mixed step that fails after
its layers wrote (corrupted) K/V is retried through the quarantine
without reading the stale positions: the tokens equal the JAX engine's
with a fault injected at the same step, and the run's without a fault.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import serving as jax_serving
from paddle_tpu.core import flags as jax_flags
from paddle_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig,
    LlamaForCausalLM as JaxLlamaForCausalLM,
)
from paddle_tpu.resilience import faultinject as jax_fi
from paddle_tpu.serving import scheduler as jax_scheduler
from paddle_tpu_torch import serving
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM, \
    load_jax_state
from paddle_tpu_torch.resilience import faultinject
from paddle_tpu_torch.serving import kv_cache
from paddle_tpu_torch.serving import scheduler as port_scheduler

FLAG_NAMES = ("FLAGS_serving_prefix_cache", "FLAGS_serving_chunked_prefill")
COMBOS = [pytest.param((False, False), id="flags_off"),
          pytest.param((True, True), id="prefix-chunked")]
COUNTERS = ("requests_in", "requests_finished", "requests_shed",
            "shed_by_reason", "finished_output_tokens", "output_tokens",
            "preemptions", "prefill_runs", "decode_steps", "prefill_chunks")
TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=64)


class Side:
    """One package's engine maker, fault injector and admission errors."""

    def __init__(self, make, fi, errors):
        self.make, self.fi, self.errors = make, fi, errors


def _set(prefix=False, chunked=False):
    values = dict(zip(FLAG_NAMES, (prefix, chunked)))
    jax_flags.set_flags(values)
    flags.set_flags(values)


def _reset_faults():
    for fi in (jax_fi, faultinject):
        fi.enable("", seed=0)       # no rules, no hits
        fi.disable()


@pytest.fixture(autouse=True)
def _clean():
    saved = dict(jax_fi._FAULTS._values)
    _reset_faults()
    yield
    _set()
    _reset_faults()
    # the JAX engine's faults count into the JAX monitor registry's
    # faults_injected_total, which reference tests read in this process:
    # put its samples back as this test found them
    with jax_fi._FAULTS._lock:
        jax_fi._FAULTS._values.clear()
        jax_fi._FAULTS._values.update(saved)


@pytest.fixture(scope="module")
def sides():
    paddle.seed(0)
    jmodel = JaxLlamaForCausalLM(JaxLlamaConfig(use_parallel=False, **TINY))
    names, values = jmodel.functional_state()
    model = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu")
    load_jax_state(model, names, [np.asarray(v) for v in values])
    return (Side(lambda **kw: jax_serving.Engine(jmodel, **kw), jax_fi,
                 jax_serving),
            Side(lambda **kw: serving.Engine(model, device="cpu", **kw),
                 faultinject, serving))


@pytest.fixture
def clock(monkeypatch):
    """One fake monotonic clock for both schedulers (arrival stamps and
    the expiry pass): ``clock[0]`` is the time."""
    t = [1000.0]
    for mod in (jax_scheduler, port_scheduler):
        monkeypatch.setattr(mod, "now", lambda: t[0])
    return t


def _prompts(seed, lengths, vocab=64):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (n,)).tolist() for n in lengths]


def _observe(side, eng, ids, rejects=(), extra=None):
    st = eng.stats()
    statuses = []
    for i in ids:
        s = dict(eng.request_status(i))
        del s["id"]
        statuses.append(s)
    state = side.fi.state()
    return {"statuses": statuses,
            "tokens": [eng.output(i) for i in ids],
            "counters": {k: st[k] for k in COUNTERS},
            "rejects": list(rejects),
            "faults": {"rules": state["rules"],
                       "site_hits": state["site_hits"]},
            "extra": extra}


def _add(side, eng, ids, rejects, prompt, **kw):
    try:
        ids.append(eng.add_request(prompt, **kw))
    except side.errors.AdmissionError as e:
        rejects.append((type(e).__name__, e.reason))


def queue_bound(side):
    """max_queue=2: the third and fourth arrivals are shed at admission;
    once the queue drains, admission opens again."""
    eng = side.make(max_slots=1, num_blocks=32, block_size=4,
                    prefill_chunk=4, max_queue=2)
    ids, rejects = [], []
    for p in _prompts(20, (5, 6, 7, 4)):
        _add(side, eng, ids, rejects, p, max_new_tokens=3)
    eng.run()
    _add(side, eng, ids, rejects, _prompts(21, (6,))[0], max_new_tokens=2)
    eng.run()
    return _observe(side, eng, ids, rejects)


def deadlines(side):
    """A dead-on-arrival request expires before admission, one with a
    long TTL finishes, and the default deadline set after construction is
    read by the next add_request."""
    eng = side.make(max_slots=1, num_blocks=32, block_size=4,
                    prefill_chunk=4)
    pa, pb, pc, pd = _prompts(22, (5, 6, 3, 4))
    ids = [eng.add_request(pa, max_new_tokens=3, deadline_s=0.0),
           eng.add_request(pb, max_new_tokens=3),
           eng.add_request(pc, max_new_tokens=2, deadline_s=3600.0)]
    eng.default_deadline_s = 0.0
    ids.append(eng.add_request(pd, max_new_tokens=2))
    eng.run()
    return _observe(side, eng, ids)


def preempted_then_expired(side, clock):
    """Two requests grow a 6-page pool dry; once one of them is preempted
    (waiting again), the clock passes both deadlines: the waiting one
    expires, the running one finishes."""
    eng = side.make(max_slots=2, num_blocks=7, block_size=4,
                    prefill_chunk=4)
    ids = [eng.add_request(p, max_new_tokens=10, deadline_s=50.0)
           for p in _prompts(10, (6, 8))]
    steps = 0
    while eng.step():
        steps += 1
        if eng.stats()["preemptions"] and clock[0] < 1100.0:
            clock[0] += 100.0
    return _observe(side, eng, ids, extra=steps)


def preempt_cap(side):
    """max_preemptions=0: no running request is a victim, so the request
    that needs a page is shed (preempt_cap) instead of livelocking."""
    eng = side.make(max_slots=2, num_blocks=6, block_size=4,
                    max_model_len=20, prefill_chunk=4, max_preemptions=0)
    ids = [eng.add_request([1, 2, 3, 4, 5], max_new_tokens=8),
           eng.add_request([6, 7, 8, 9, 10], max_new_tokens=8)]
    eng.run()
    return _observe(side, eng, ids)


def preempt_cap_one(side):
    """max_preemptions=1 over a starved pool: one preemption each at
    most, then the cap."""
    eng = side.make(max_slots=3, num_blocks=8, block_size=4,
                    prefill_chunk=4, max_preemptions=1)
    ids = [eng.add_request(p, max_new_tokens=9)
           for p in _prompts(23, (6, 5, 7))]
    eng.run()
    return _observe(side, eng, ids)


def drain(side):
    """drain() finishes the running and the queued request, then rejects
    every new one."""
    eng = side.make(max_slots=2, num_blocks=32, block_size=4,
                    prefill_chunk=4)
    ids = [eng.add_request([1, 2, 3], max_new_tokens=4),
           eng.add_request([4, 5], max_new_tokens=3),
           eng.add_request([6, 7, 8, 9], max_new_tokens=2)]
    eng.step()
    out = eng.drain()
    rejects = []
    _add(side, eng, ids, rejects, [1], max_new_tokens=1)
    return _observe(side, eng, ids, rejects,
                    extra=(eng.draining, eng.has_work(),
                           [out[i] for i in ids]))


def poison_prefill(side):
    """The reference's chaos acceptance: a transient engine fault on the
    first step, a poison second prefill, a dead-on-arrival deadline and a
    queue overflow; the rest finish."""
    eng = side.make(max_slots=2, num_blocks=32, block_size=4,
                    prefill_chunk=4, max_queue=4)
    side.fi.enable("serving.step:error@1;serving.prefill:error@2", seed=0)
    ids, rejects = [], []
    ids.append(eng.add_request([1, 2, 3], max_new_tokens=4))
    ids.append(eng.add_request([4, 5, 6], max_new_tokens=4))
    ids.append(eng.add_request([7, 8], max_new_tokens=3))
    ids.append(eng.add_request([9, 10], max_new_tokens=3, deadline_s=0.0))
    for _ in range(3):
        _add(side, eng, ids, rejects, [1], max_new_tokens=1)
    eng.run()
    return _observe(side, eng, ids, rejects)


def decode_bisect(side):
    """The first batched decode fails (both rows quarantined and
    requeued), then the first solo decode fails: that request is the
    named poison, the other finishes alone."""
    eng = side.make(max_slots=2, num_blocks=32, block_size=4,
                    prefill_chunk=4)
    side.fi.enable("serving.decode:error@1..2", seed=0)
    ids = [eng.add_request([1, 2, 3], max_new_tokens=4),
           eng.add_request([4, 5, 6], max_new_tokens=4)]
    eng.run()
    return _observe(side, eng, ids)


def seeded_chaos(side):
    """Probabilistic and every-Nth rules over six requests: the same
    seeded stream must fire at the same calls in both packages."""
    eng = side.make(max_slots=3, num_blocks=16, block_size=4,
                    prefill_chunk=4)
    side.fi.enable("serving.prefill:error@p0.3;serving.decode:error@%5;"
                   "serving.step:delay=0@2..3", seed=3)
    ids = [eng.add_request(p, max_new_tokens=5)
           for p in _prompts(24, (4, 9, 6, 3, 7, 5))]
    eng.run()
    return _observe(side, eng, ids)


SCENARIOS = [queue_bound, deadlines, preempt_cap, preempt_cap_one, drain,
             poison_prefill, decode_bisect, seeded_chaos]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("combo", COMBOS)
def test_resilience_matches_reference(sides, combo, scenario):
    _set(*combo)
    jax_side, port_side = sides
    want = scenario(jax_side)
    jax_side.fi.disable()
    got = scenario(port_side)
    assert got == want
    c = got["counters"]
    terminal = [s["state"] for s in got["statuses"]]
    assert all(s in ("finished", "expired", "shed", "failed")
               for s in terminal)
    assert c["requests_finished"] == terminal.count("finished")
    assert c["requests_shed"] == (sum(c["shed_by_reason"].values()))
    assert c["finished_output_tokens"] == sum(
        len(t) for t, s in zip(got["tokens"], terminal) if s == "finished")
    # each scenario exercises what it names
    reasons = c["shed_by_reason"]
    if scenario is queue_bound:
        assert reasons == {"queue_full": 2} and len(got["rejects"]) == 2
    if scenario is deadlines:
        assert reasons == {"expired": 2}
        assert [s["reason"] for s in got["statuses"]] == [
            "deadline", None, None, "deadline"]
    if scenario is preempt_cap:
        assert reasons == {"preempt_cap": 1}
    if scenario is drain:
        assert got["rejects"] == [("DrainingError", "draining")]
        assert got["extra"][:2] == (True, False)
    if scenario is poison_prefill:
        assert reasons["poison"] == 1 and reasons["expired"] == 1
        assert reasons["queue_full"] >= 1
        failed = [s for s in got["statuses"] if s["state"] == "failed"]
        assert "InjectedFault" in failed[0]["error"]
    if scenario is decode_bisect:
        assert sorted(terminal) == ["failed", "finished"]
        assert c["preemptions"] == 2


@pytest.mark.parametrize("combo", COMBOS)
def test_deadline_of_a_preempted_request(sides, combo, clock):
    _set(*combo)
    jax_side, port_side = sides
    want = preempted_then_expired(jax_side, clock)
    clock[0] = 1000.0
    got = preempted_then_expired(port_side, clock)
    assert got == want
    if not combo[0]:
        # the starved pool preempts; the waiting victim expires
        assert got["counters"]["shed_by_reason"] == {"expired": 1}
        assert sorted(s["state"] for s in got["statuses"]) == [
            "expired", "finished"]


@pytest.mark.parametrize("combo", COMBOS)
def test_goodput_count_matches_reference(sides, combo):
    """finished_output_tokens (the goodput numerator) counts every
    finished request's tokens, the zero-token request included, and
    nothing of a shed one."""
    _set(*combo)
    out = []
    for side in sides:
        eng = side.make(max_slots=2, num_blocks=32, block_size=4,
                        prefill_chunk=4)
        ids = [eng.add_request(p, max_new_tokens=n) for p, n in zip(
            _prompts(26, (5, 7, 3, 6)), (4, 0, 6, 3))]
        ids.append(eng.add_request([2, 3], max_new_tokens=5,
                                   deadline_s=0.0))
        eng.run()
        st = eng.stats()
        out.append((st["finished_output_tokens"], st["requests_finished"],
                    st["requests_shed"], [eng.output(i) for i in ids]))
        assert st["goodput_tok_s"] > 0
    assert out[0] == out[1]
    assert out[1][:3] == (4 + 0 + 6 + 3, 4, 1)


def test_fault_schedule_parity_table():
    """The port's copy of the schedule grammar parses and prints like the
    reference's, and rejects what it rejects."""
    spec = ("serving.step:error@1;serving.prefill:error@p0.25;"
            "serving.decode:delay=0.01@%4;store.get:drop@2..5;"
            "pg.all_reduce:error@3..;x:lost_ack")
    assert [str(r) for r in faultinject.parse_schedule(spec)] == [
        str(r) for r in jax_fi.parse_schedule(spec)]
    for bad in ("nosite", "a:bogus", "a:error@%0", "a:error@x"):
        with pytest.raises(ValueError):
            jax_fi.parse_schedule(bad)
        with pytest.raises(ValueError):
            faultinject.parse_schedule(bad)


def _failing_step(eng, target):
    """Make the engine's ``target``-th decode (or mixed) step fail after
    every layer wrote its K/V, with garbage K/V in place of the real
    values: an organic failure mid-step, as the card could raise it."""
    armed = {"on": False}
    name = "_mixed_once" if eng.chunked_prefill else "_decode_once"
    orig_step = getattr(eng, name)
    calls = [0]

    def step(rows):
        calls[0] += 1
        armed["on"] = calls[0] == target
        try:
            return orig_step(rows)
        finally:
            armed["on"] = False
    setattr(eng, name, step)
    view = kv_cache.PagedMixedView if eng.chunked_prefill \
        else kv_cache.PagedDecodeView
    orig_attend = view.update_and_attend
    orig_write = kv_cache._write_pages

    def write(pool, pages, offs, k, v):
        if armed["on"]:
            k, v = k * 0 + 1e4, v * 0 - 1e4
        return orig_write(pool, pages, offs, k, v)

    def attend(self, q, k, v):
        out = orig_attend(self, q, k, v)
        if armed["on"] and self.pool is eng.cache.pools[-1]:
            raise RuntimeError("device fault after the K/V writes")
        return out
    return write, attend, view


def _retry_run(make, fail=None):
    eng = make(max_slots=2, num_blocks=32, block_size=4, prefill_chunk=4)
    ids = [eng.add_request(p, max_new_tokens=6)
           for p in _prompts(25, (9, 6))]
    patches = fail(eng) if fail else None
    return eng, ids, patches


@pytest.mark.parametrize("combo", COMBOS)
def test_failed_step_retries_without_stale_kv(sides, combo, monkeypatch):
    _set(*combo)
    jax_side, port_side = sides
    target = 3       # a step with both requests running (past prefill)
    jax_side.fi.enable("serving.decode:error@%d" % target, seed=0)
    jeng, jids, _ = _retry_run(jax_side.make)
    jeng.run()
    jax_side.fi.disable()
    want = _observe(jax_side, jeng, jids)

    clean, cids, _ = _retry_run(port_side.make)
    clean.run()

    eng, ids, (write, attend, view) = _retry_run(
        port_side.make, lambda e: _failing_step(e, target))
    monkeypatch.setattr(kv_cache, "_write_pages", write)
    monkeypatch.setattr(view, "update_and_attend", attend)
    eng.run()
    got = _observe(port_side, eng, ids)
    # the organic failure took the injected fault's path: both rows
    # quarantined, requeued and re-prefilled, nobody failed
    assert got["statuses"] == want["statuses"]
    assert got["counters"] == want["counters"]
    assert got["counters"]["preemptions"] == 2
    assert all(s["state"] == "finished" for s in got["statuses"])
    # and read nothing the failed step wrote
    assert got["tokens"] == want["tokens"] == [clean.output(i) for i in cids]
