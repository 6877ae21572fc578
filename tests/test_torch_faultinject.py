"""The port's copy of resilience/faultinject against the reference's.

For every schedule (``@N``, ``@N..``, ``@N..M``, ``@pX``, ``@%N``,
``delay=``, cooperative kinds, several rules on one site) and seed, the
same sequence of site calls must fire at the same calls in both
packages, with the same parsed rules, hit and fired counts; bad rules
must be refused by both.
"""
import pytest

from paddle_tpu.resilience import faultinject as jax_fi
from paddle_tpu_torch.resilience import faultinject as fi

SCHEDULES = [
    "serving.prefill:error@3",
    "serving.decode:error@2..4",
    "serving.step:error@5..",
    "serving.prefill:error@p0.3",
    "serving.decode:error@%3",
    "serving.step:delay=0@2;serving.prefill:error@p0.5",
    "serving.prefill:error@p0.2;serving.decode:error@p0.6;"
    "serving.step:error@%4",
    "serving.decode:delay=0.0@1..2;serving.decode:error",
    "store.get:drop@2;store.set:broken_fd@%2;store.add:lost_ack@p0.5",
    "serving.prefill:error",
]
SEEDS = (0, 1, 7, 12345)
SITES = ["serving.prefill", "serving.decode", "serving.step", "store.get",
         "store.set", "store.add", "serving.prefill", "serving.decode"]


@pytest.fixture(autouse=True)
def _disarm():
    saved = dict(jax_fi._FAULTS._values)
    yield
    for mod in (jax_fi, fi):
        mod.enable("", seed=0)
        mod.disable()
    # the reference's fire() also counts into the JAX monitor registry's
    # faults_injected_total, which reference tests read in this process:
    # put its samples back as this test found them
    with jax_fi._FAULTS._lock:
        jax_fi._FAULTS._values.clear()
        jax_fi._FAULTS._values.update(saved)


def _trace(mod, schedule, seed, calls=60):
    mod.enable(schedule, seed=seed)
    out = []
    for i in range(calls):
        site = SITES[(i * 5 + i // 3) % len(SITES)]
        supports = ("drop", "broken_fd") if site.startswith("store") else ()
        try:
            out.append((site, mod.fire(site, _supports=supports)))
        except mod.InjectedFault as e:
            out.append((site, "raised", str(e)))
    state = mod.state()
    mod.disable()
    return out, {"rules": state["rules"], "site_hits": state["site_hits"],
                 "seed": state["seed"], "enabled": state["enabled"]}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_same_calls_fire(schedule, seed):
    assert [str(r) for r in fi.parse_schedule(schedule)] == [
        str(r) for r in jax_fi.parse_schedule(schedule)]
    want = _trace(jax_fi, schedule, seed)
    got = _trace(fi, schedule, seed)
    assert got == want
    fired = sum(r["fired"] for r in got[1]["rules"])
    injected = fi.state()["injected"]
    assert sum(injected.values()) == fired


def test_fires_something_and_counts_by_site():
    out, state = _trace(fi, "serving.prefill:error@p0.5", 3, calls=40)
    raised = [c for c in out if c[1] == "raised"]
    assert raised and len(raised) < sum(1 for c in out
                                        if c[0] == "serving.prefill")
    assert fi.state()["injected"] == {"serving.prefill:error": len(raised)}


@pytest.mark.parametrize("bad", ["nosite", ":error", "a:bogus",
                                 "a:error@%0", "a:error@x", "a:delay=x"])
def test_bad_rules_refused_by_both(bad):
    with pytest.raises(ValueError):
        jax_fi.parse_schedule(bad)
    with pytest.raises(ValueError):
        fi.parse_schedule(bad)


def test_disabled_is_inert():
    fi.enable("serving.step:error", seed=0)
    fi.disable()
    assert not fi.is_enabled()
    assert fi.fire("serving.step") is None
    assert fi.state()["site_hits"] == {}
