"""Record/replay: the port's ``serving/replay.py`` and
``tools/ptreplay.py`` against the reference's
(``paddle_tpu/serving/replay.py``, ``tools/ptreplay.py``).

Both engines get the same tiny Llama's weights (copied through
``load_jax_state``) and the same requests; the port runs on the CPU.
Checked: with ``FLAGS_serving_replay`` off the recorder is None and
nothing is recorded; recording changes no token; admission and terminal
entries carry the reference's keys and values for the same workload (the
ids, engine ids, timings and wall clocks aside), an expired request its
terminal reason; finished-first eviction; a journal written by either
package loads in the other's ``load_journal``; a journal the JAX engine
wrote, re-driven through the port's engine on the same weights, gives the
same greedy tokens under each flag combination (each held only against
itself: the reference is not scheduling-invariant across combinations);
a perturbed weight is detected at its first diverging index and the
matrix names ``weights``; ``--against``; and the serving benchmark's
``--record-out`` followed by ``--replay``.

The JAX recorder counts into its monitor registry (``replay_*`` series),
which reference tests read in this process: a fixture puts those samples
back as each test found them.
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import serving as jax_serving
from paddle_tpu.core import flags as jax_flags
from paddle_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig,
    LlamaForCausalLM as JaxLlamaForCausalLM,
)
from paddle_tpu.monitor import registry as jax_registry
from paddle_tpu.serving import replay as jax_replay
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM, \
    load_jax_state
from paddle_tpu_torch.serving import Engine, replay
from paddle_tpu_torch.tools import ptreplay, serving_benchmark

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
              num_hidden_layers=2, num_attention_heads=4,
              max_position_embeddings=96)
ALL = ("FLAGS_serving_replay", "FLAGS_serving_prefix_cache",
       "FLAGS_serving_chunked_prefill", "FLAGS_serving_quant_kv",
       "FLAGS_serving_quant_weights")
AXES = ALL[1:]
COMBOS = [pytest.param(c, id="-".join(a for a, on in zip(
    ("prefix", "chunked", "quant_kv", "quant_weights"), c) if on)
    or "flags_off")
    for c in ((False, False, False, False), (True, False, False, False),
              (True, True, False, False), (False, False, True, False),
              (False, False, False, True), (True, True, True, True))]
GEOMETRY = dict(max_slots=2, num_blocks=32, block_size=8)
# the entry keys whose values belong to one process and one run
VOLATILE = ("id", "engine", "admitted_wall", "admitted_mono",
            "completed_wall", "timings_s")
DISABLED_PAYLOAD = {"enabled": False, "requests": [], "dispatches": 0}


def _ref_ptreplay():
    path = os.path.join(REPO, "tools", "ptreplay.py")
    spec = importlib.util.spec_from_file_location("ref_ptreplay", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _set(**on):
    values = {f: bool(on.get(f)) for f in ALL}
    jax_flags.set_flags(values)
    flags.set_flags(values)


def _reset():
    _set()
    for mod in (jax_replay, replay):
        mod.disable()
        mod.clear()


@pytest.fixture(autouse=True)
def _clean():
    saved = {m.name: dict(m._values)
             for m in jax_registry.get_registry().metrics()
             if m.name.startswith("replay_")}
    _reset()
    yield
    _reset()
    for m in jax_registry.get_registry().metrics():
        if m.name.startswith("replay_"):
            with m._lock:
                m._values.clear()
                m._values.update(saved.get(m.name, {}))


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jmodel = JaxLlamaForCausalLM(JaxLlamaConfig(use_parallel=False,
                                                **CONFIG))
    names, values = jmodel.functional_state()
    model = LlamaForCausalLM(LlamaConfig(**CONFIG), device="cpu")
    load_jax_state(model, names, [np.asarray(v) for v in values])
    return jmodel, model


def _workload(seed, n=6):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 64, (5 + i % 4,)).tolist(), 4 + i % 3)
            for i in range(n)]


def _jax_engine(jmodel, **kw):
    return jax_serving.Engine(jmodel, **dict(GEOMETRY, **kw))


def _port_engine(model, **kw):
    return Engine(model, device="cpu", **dict(GEOMETRY, **kw))


def _record(make, work, **eng_kw):
    eng = make(**eng_kw)
    ids = [eng.add_request(p, max_new_tokens=n, **kw)
           for p, n, *rest in work for kw in [rest[0] if rest else {}]]
    eng.run()
    return eng, ids


def _stable(entry):
    return {k: v for k, v in entry.items() if k not in VOLATILE}


def test_flag_off_records_nothing(models):
    _, model = models
    eng, ids = _record(lambda **kw: _port_engine(model, **kw),
                       _workload(1, 3))
    assert eng._replay is None
    assert all(len(eng.output(i)) for i in ids)
    assert replay.payload() == DISABLED_PAYLOAD == jax_replay.payload()
    assert replay.header()["requests"] == 0


def test_recording_never_perturbs_tokens(models):
    _, model = models
    work = _workload(2, 4)
    off, oid = _record(lambda **kw: _port_engine(model, **kw), work)
    _set(FLAGS_serving_replay=True)
    on, nid = _record(lambda **kw: _port_engine(model, **kw), work)
    assert on._replay is not None
    assert [off.output(i) for i in oid] == [on.output(i) for i in nid]
    assert replay.payload()["recorded_total"] == len(work)


@pytest.mark.parametrize("values", [
    pytest.param(dict(), id="flags_off"),
    pytest.param(dict(FLAGS_serving_quant_kv=True), id="quant_kv"),
    pytest.param(dict(FLAGS_serving_prefix_cache=True,
                      FLAGS_serving_chunked_prefill=True),
                 id="prefix-chunked")])
def test_entries_match_the_reference(models, values):
    """The same workload (an EOS stop and a zero-length request among
    them) gives entries and engine snapshots with the reference's keys
    and values."""
    jmodel, model = models
    work = _workload(3, 4) + [([7, 8, 9], 0), ([1, 2, 3, 4], 5,
                                               {"eos_token_id": 5})]
    _set(FLAGS_serving_replay=True, **values)
    _record(lambda **kw: _jax_engine(jmodel, **kw), work)
    _record(lambda **kw: _port_engine(model, **kw), work)
    want = list(jax_replay._state.entries.values())
    got = list(replay._state.entries.values())
    assert len(got) == len(want) == len(work)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert _stable(g) == _stable(w)
        assert set(g["timings_s"]) == set(w["timings_s"])
    assert [e["state"] for e in got][-2:] == ["finished", "finished"]
    jhead, head = jax_replay.header(), replay.header()
    assert set(head) == set(jhead)
    assert list(head["engines"].values()) == list(jhead["engines"].values())
    digest = replay.payload()["requests"]
    jdigest = jax_replay.payload()["requests"]
    assert [{k: v for k, v in r.items() if k != "id"} for r in digest] == [
        {k: v for k, v in r.items() if k != "id"} for r in jdigest]


def test_expired_request_terminal_reason(models):
    jmodel, model = models
    _set(FLAGS_serving_replay=True)
    work = [([1, 2, 3, 4], 4), ([5, 6, 7, 8], 4, {"deadline_s": 0.0})]
    rows = []
    for mod, make in ((jax_replay, lambda **kw: _jax_engine(jmodel, **kw)),
                      (replay, lambda **kw: _port_engine(model, **kw))):
        _record(make, work, max_slots=1)
        rows.append([_stable(e) for e in mod._state.entries.values()])
    assert rows[0] == rows[1]
    keep, drop = rows[1]
    assert keep["state"] == "finished"
    assert (drop["state"], drop["reason"]) == ("expired", "deadline")
    assert drop["output_token_hash"] == replay.token_hash(())


def test_eviction_is_finished_first(models):
    _, model = models
    _set(FLAGS_serving_replay=True)
    replay.enable(capacity=2)
    eng, ids = _record(lambda **kw: _port_engine(model, **kw),
                       _workload(4, 4))
    p = replay.payload()
    assert (p["recorded_total"], p["evictions"], p["entries"]) == (4, 2, 2)
    assert [r["id"] for r in p["requests"]] == ids[2:]
    # an all-open journal still evicts its oldest entry
    replay.clear()
    replay.enable(capacity=1)
    eng = _port_engine(model)
    a = eng.add_request([1, 2, 3], max_new_tokens=2)
    b = eng.add_request([4, 5, 6], max_new_tokens=2)
    assert [r["id"] for r in replay.payload()["requests"]] == [b] != [a]
    eng.run()


def test_journals_load_across_packages(models, tmp_path):
    jmodel, model = models
    _set(FLAGS_serving_replay=True)
    work = _workload(5, 3)
    _record(lambda **kw: _jax_engine(jmodel, **kw), work)
    _record(lambda **kw: _port_engine(model, **kw), work)
    jpath, path = str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")
    jax_replay.write_journal(jpath)
    replay.write_journal(path)
    for load in (jax_replay.load_journal, replay.load_journal):
        (h1, e1), (h2, e2) = load(jpath), load(path)
        assert set(h1) == set(h2)
        assert [_stable(e) for e in e1] == [_stable(e) for e in e2]
    # a journal of another version fails loudly in the port as well
    with open(path) as f:
        lines = f.read().splitlines()
    head = json.loads(lines[0])
    head["version"] = 2
    bad = str(tmp_path / "bad.jsonl")
    with open(bad, "w") as f:
        f.write("\n".join([json.dumps(head)] + lines[1:]))
    with pytest.raises(ValueError, match="version"):
        replay.load_journal(bad)


def _jax_journal(jmodel, values, path, n=6):
    _set(FLAGS_serving_replay=True, **dict(zip(AXES, values)))
    _record(lambda **kw: _jax_engine(jmodel, **kw), _workload(6, n),
            prefill_chunk=4)
    jax_replay.note_model({"preset": "tiny", "seed": 0, "config": CONFIG})
    jax_replay.write_journal(path)
    _reset()


@pytest.mark.parametrize("values", COMBOS)
def test_jax_journal_replays_through_the_port(models, values, tmp_path):
    """The JAX engine's recording, re-driven through the port's engine
    with the JAX weights carried across, under its own combination."""
    jmodel, model = models
    path = str(tmp_path / "jax.jsonl")
    _jax_journal(jmodel, values, path)
    head, entries = replay.load_journal(path)
    assert all(e["flags"] == dict(zip(AXES, values)) for e in entries)
    report = ptreplay.replay_entries(head, entries, full=True, model=model,
                                     device="cpu")
    assert report["replayed"] == len(entries) == 6
    assert report["divergence_count"] == 0, report["divergences"]
    # the replay recorded nothing and restored the flags it latched
    assert replay.payload() == DISABLED_PAYLOAD
    assert not any(flags.flag(f) for f in ALL)


def test_jax_journal_refuses_a_rebuild(models, tmp_path):
    """The torch RNG cannot draw paddle.seed's weights: rebuilding a JAX
    journal's model raises instead of reporting a false divergence."""
    jmodel, _ = models
    path = str(tmp_path / "jax.jsonl")
    _jax_journal(jmodel, (False,) * 4, path, n=2)
    head, entries = replay.load_journal(path)
    with pytest.raises(ValueError, match="paddle.seed"):
        ptreplay.replay_entries(head, entries, device="cpu")
    args = ptreplay.parser().parse_args(["run", path, "--device", "cpu",
                                         "--out", ""])
    with pytest.raises(ValueError, match="load_jax_state"):
        ptreplay.run_replay(args)


def _port_journal(path, seed=0, values=(False,) * 4, perturb=False):
    """A port recording whose meta rebuilds its model: the port's own
    initialisation from ``seed`` on the CPU."""
    model = LlamaForCausalLM(LlamaConfig(**CONFIG), device="cpu",
                             generator=torch.Generator().manual_seed(seed))
    if perturb:
        ptreplay._perturb_one_leaf(model)
    _set(FLAGS_serving_replay=True, **dict(zip(AXES, values)))
    _record(lambda **kw: _port_engine(model, **kw), _workload(7, 6))
    replay.note_model({"preset": "tiny", "seed": seed, "config": CONFIG,
                       "weights": ptreplay.weights_meta("cpu")})
    replay.write_journal(path)
    _reset()


def test_perturbed_leaf_detected_and_matrix_names_weights(tmp_path):
    path = str(tmp_path / "port.jsonl")
    _port_journal(path)
    head, entries = replay.load_journal(path)
    clean = ptreplay.replay_entries(head, entries, device="cpu")
    assert clean["divergence_count"] == 0 and clean["replayed"] == 6
    bad = ptreplay.replay_entries(head, entries, full=True, perturb=True,
                                  device="cpu")
    assert bad["perturbed_leaf"] == "llama.embed_tokens.weight"
    assert bad["divergence_count"] > 0
    for row in bad["divergences"]:
        ref = _ref_ptreplay()._first_divergence(row["recorded_tokens"],
                                                row["replayed_tokens"])
        assert row["first_divergence"] == ref is not None
    matrix = ptreplay.matrix_bisect(head, entries, perturb=True,
                                    device="cpu")
    assert matrix["bisected_axes"] == ["weights"] and not matrix["axes"]
    before = replay.divergences().get("weights", 0)
    out = str(tmp_path / "matrix.json")
    assert ptreplay.main(["run", path, "--device", "cpu", "--matrix",
                          "--out", out]) == 0
    with open(out) as f:
        report = json.load(f)
    assert report["matrix"]["baseline_divergences"] == 0
    assert set(report["matrix"]["axes"]) == {"prefix", "chunked",
                                             "quant_kv", "quant_weights"}
    assert report["matrix"]["axes"]["prefix"]["divergences"] == 0
    assert report["matrix"]["axes"]["chunked"]["divergences"] == 0
    assert replay.divergences().get("weights", 0) == before


def test_against_diffs_two_recordings(tmp_path):
    a, b, c = (str(tmp_path / n) for n in ("a.jsonl", "b.jsonl", "c.jsonl"))
    _port_journal(a)
    _port_journal(b, perturb=True)
    _port_journal(c)
    ref = _ref_ptreplay()
    ha, ea = replay.load_journal(a)
    hb, eb = replay.load_journal(b)
    got = ptreplay.diff_journals(ha, ea, hb, eb, full=True)
    assert got == ref.diff_journals(ha, ea, hb, eb, full=True)
    assert got["pairs"] == 6 and got["divergence_count"] > 0
    assert ptreplay.main(["run", a, "--against", b, "--out", ""]) == 2
    assert ptreplay.main(["run", a, "--against", c, "--out", ""]) == 0


@pytest.mark.parametrize("extra", [
    pytest.param([], id="flags_off"),
    pytest.param(["--prefix-cache", "--chunked-prefill",
                  "--shared-prefix-tokens", "32", "--prefix-groups", "2"],
                 id="prefix-chunked")])
def test_benchmark_record_then_replay(tmp_path, extra):
    journal = str(tmp_path / "j.jsonl")
    common = ["--preset", "tiny", "--device", "cpu", "--requests", "6",
              "--rate", "200", "--seed", "3"]
    assert serving_benchmark.main(common + ["--record-out", journal,
                                            "--out", ""] + extra) == 0
    head, entries = replay.load_journal(journal)
    assert len(entries) == 6 and all(e["state"] == "finished"
                                     for e in entries)
    assert head["model"]["weights"] == ptreplay.weights_meta("cpu")
    assert head["model"]["config"] == serving_benchmark.PRESETS["tiny"]
    out = str(tmp_path / "report.json")
    assert serving_benchmark.main(["--device", "cpu", "--replay", journal,
                                   "--out", out]) == 0
    with open(out) as f:
        report = json.load(f)
    assert (report["replayed"], report["divergence_count"]) == (6, 0)
    # the recording left the process as it found it
    assert not replay.is_enabled() and not flags.flag("FLAGS_serving_replay")


def test_benchmark_replay_is_ptreplay_run(tmp_path):
    """``--replay`` delegates to ptreplay's run with the tool's device."""
    journal = str(tmp_path / "j.jsonl")
    _port_journal(journal)
    seen = {}

    def fake(args, model=None):
        seen.update(vars(args))
        return 2

    orig = ptreplay.run_replay
    ptreplay.run_replay = fake
    try:
        rc = serving_benchmark.main(["--device", "cpu", "--replay", journal])
    finally:
        ptreplay.run_replay = orig
    assert rc == 2
    assert seen == dict(journal=journal, out=None, full=False, matrix=False,
                        against=None, device="cpu")
