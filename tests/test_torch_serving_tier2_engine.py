"""The port's serving engine against the JAX engine under every
combination of the tier-2 flags (prefix cache, chunked prefill, int8 KV
pages).

Both engines get the same weights (copied through ``load_jax_state``)
and the same workloads: the scenarios of tests/test_serving_prefix.py
(copy-on-write divergence, a resubmitted prompt, reclaim before preempt,
a long prefill beside a short request, a starved pool under chunked
prefill, a multi-page prompt). For each combination the port must give
the JAX engine's greedy tokens AND its scheduling counters for the SAME
combination; combinations are never compared with each other, since the
reference itself is not scheduling-invariant under int8 pages (ROADMAP
C.1). The port runs on the CPU (``device="cpu"``), which takes each
kernel's plain version.
"""
import itertools

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
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM, \
    load_jax_state
from paddle_tpu_torch.serving import Engine
from torch_threads import one_torch_thread  # noqa: F401

FLAG_NAMES = ("FLAGS_serving_prefix_cache", "FLAGS_serving_chunked_prefill",
              "FLAGS_serving_quant_kv")
COMBOS = [pytest.param(c, id="-".join(n for n, on in zip(
    ("prefix", "chunked", "quant_kv"), c) if on) or "flags_off")
    for c in itertools.product((False, True), repeat=3)]
# the counters both engines keep under the same stats() keys
COUNTERS = ("requests_finished", "preemptions", "prefill_runs",
            "decode_steps", "output_tokens", "prefix_hit_tokens",
            "prefix_lookup_tokens", "prefix_evictions", "prefix_insert_pages",
            "prefix_cached_pages", "cow_clones", "prefill_chunks",
            "kv_quant_pages", "quant_dequant_bytes")
# the tiny Llama of tests/test_serving_quant.py
TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=64)


def _set(prefix=False, chunked=False, quant_kv=False):
    values = dict(zip(FLAG_NAMES, (prefix, chunked, quant_kv)))
    jax_flags.set_flags(values)
    flags.set_flags(values)


@pytest.fixture(autouse=True)
def _restore_flags():
    yield
    _set()


def _pair(seed, **kw):
    paddle.seed(seed)
    jmodel = JaxLlamaForCausalLM(JaxLlamaConfig(use_parallel=False, **kw))
    names, values = jmodel.functional_state()
    model = LlamaForCausalLM(LlamaConfig(**kw), device="cpu")
    load_jax_state(model, names, [np.asarray(v) for v in values])
    return jmodel, model


@pytest.fixture(scope="module")
def models():
    return _pair(0, **TINY)


def _makers(models):
    jmodel, model = models
    return (lambda **kw: jax_serving.Engine(jmodel, **kw),
            lambda **kw: Engine(model, device="cpu", **kw))


def _observe(eng, ids, extra=None):
    st = eng.stats()
    return {"tokens": [eng.output(i) for i in ids],
            "counters": {k: st[k] for k in COUNTERS},
            "cached": [eng.request_metrics(i)["prefix_cached_tokens"]
                       for i in ids],
            "extra": extra}


def _prompts(seed, lengths, vocab=64):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (n,)).tolist() for n in lengths]


def cow_divergence(make):
    """B shares 14 of A's 16 prompt tokens: 3 full pages and a 2-token
    partial share of A's 4th page, so B's suffix write copies on write."""
    rng = np.random.RandomState(3)
    base = rng.randint(0, 64, (16,)).tolist()
    pb = base[:14] + rng.randint(0, 64, (2,)).tolist()
    eng = make(max_slots=2, num_blocks=64, block_size=4, prefill_chunk=4)
    ia = eng.add_request(base, max_new_tokens=6)
    eng.run()
    ib = eng.add_request(pb, max_new_tokens=6)
    eng.run()
    return _observe(eng, [ia, ib])


def resubmission(make):
    """The same prompt twice: the second admission matches all but one
    token."""
    prompt = _prompts(4, (16,))[0]
    eng = make(max_slots=1, num_blocks=64, block_size=4, prefill_chunk=4)
    r1 = eng.add_request(prompt, max_new_tokens=5)
    eng.run()
    r2 = eng.add_request(prompt, max_new_tokens=5)
    eng.run()
    return _observe(eng, [r1, r2])


def reclaim_before_preempt(make):
    """7 usable pages: a finished request leaves cached pages, then two
    requests grow the pool dry; cached pages go before live work."""
    warm, pb, pc = _prompts(8, (8, 5, 5))
    eng = make(max_slots=2, num_blocks=8, block_size=4, prefill_chunk=4)
    rw = eng.add_request(warm, max_new_tokens=2)
    eng.run()
    ib = eng.add_request(pb, max_new_tokens=6)
    ic = eng.add_request(pc, max_new_tokens=6)
    eng.run()
    return _observe(eng, [rw, ib, ic])


def long_prefill_beside_short(make):
    """A 24-token prompt and a 4-token one; the step-by-step states show
    whether the short request finished while the long one prefilled."""
    long_p, short_p = _prompts(9, (24, 4))
    eng = make(max_slots=2, num_blocks=64, block_size=4, prefill_chunk=4)
    il = eng.add_request(long_p, max_new_tokens=4)
    is_ = eng.add_request(short_p, max_new_tokens=2)
    states = []
    while eng.step():
        states.append((eng.requests[il].state.value,
                       eng.requests[is_].state.value))
    return _observe(eng, [il, is_], states)


def starved_pool(make):
    """6 usable pages for two growing requests: preempt and recompute."""
    prompts = _prompts(10, (6, 8))
    eng = make(max_slots=2, num_blocks=7, block_size=4, prefill_chunk=4)
    ids = [eng.add_request(p, max_new_tokens=10) for p in prompts]
    eng.run()
    return _observe(eng, ids)


def multi_page_prompt(make):
    prompt = _prompts(2, (11,))[0]
    eng = make(max_slots=1, num_blocks=16, block_size=4, prefill_chunk=4)
    rid = eng.add_request(prompt, max_new_tokens=5)
    eng.run()
    return _observe(eng, [rid])


SCENARIOS = [cow_divergence, resubmission, reclaim_before_preempt,
             long_prefill_beside_short, starved_pool, multi_page_prompt]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("combo", COMBOS)
def test_engine_matches_reference(models, combo, scenario):
    _set(*combo)
    jax_make, port_make = _makers(models)
    want = scenario(jax_make)
    got = scenario(port_make)
    assert got == want
    prefix, chunked, quant_kv = combo
    c = got["counters"]
    assert c["requests_finished"] == len(got["tokens"])
    # each scenario exercises what its flags switch on
    if scenario is cow_divergence and prefix:
        assert c["cow_clones"] >= 1 and got["cached"][1] == 14
    if scenario is resubmission and prefix:
        assert got["cached"][1] == 15
    if scenario is reclaim_before_preempt and prefix:
        assert c["prefix_evictions"] >= 1 and c["preemptions"] == 0
    if scenario is long_prefill_beside_short and chunked:
        assert ("prefill", "finished") in got["extra"]
        assert c["prefill_chunks"] >= 6
    if scenario is starved_pool and not prefix:
        assert c["preemptions"] >= 1
    if quant_kv:
        assert c["kv_quant_pages"] > 0 and c["quant_dequant_bytes"] > 0
    else:
        assert c["kv_quant_pages"] == 0 == c["quant_dequant_bytes"]


@pytest.mark.parametrize("combo", [(True, False, True), (True, True, True),
                                   (True, True, False)],
                         ids=["prefix-quant_kv", "all_flags",
                              "prefix-chunked"])
def test_gqa_model_matches_reference(combo):
    """Two kv heads for four query heads: the mixed view's pool writes
    and both attention functions fold GQA like the reference."""
    pair = _pair(1, **dict(TINY, num_key_value_heads=2))
    _set(*combo)
    jax_make, port_make = _makers(pair)
    for scenario in (cow_divergence, starved_pool):
        assert scenario(port_make) == scenario(jax_make)


def test_flags_off_engine_is_the_tier1_engine(models):
    _, model = models
    eng = Engine(model, device="cpu", max_slots=2, num_blocks=64,
                 block_size=4)
    assert eng.prefix_cache is None and eng.scheduler.prefix_cache is None
    assert not eng.chunked_prefill and not eng.quant_kv
    pool = eng.cache.pools[0]
    assert pool.k.dtype == torch.float32 and pool.k_scale is None
    ids = [eng.add_request(p, max_new_tokens=6)
           for p in _prompts(5, (5, 9, 12))]
    eng.run()
    st = eng.stats()
    for key in COUNTERS[5:] + ("mixed_steps", "mixed_tokens"):
        assert st[key] == 0, key
    assert st["mixed_s"] == 0.0
    # the exclusive-ownership path: nothing was ever shared
    assert eng.cache.allocator._refs == {}
    assert all(eng.request_metrics(i)["prefix_cached_tokens"] == 0
               for i in ids)


def test_flags_latched_at_construction(models):
    _, model = models
    prompts = _prompts(6, (10, 7))
    off = Engine(model, device="cpu", max_slots=2, num_blocks=64,
                 block_size=4, prefill_chunk=4)
    _set(True, True, True)
    on = Engine(model, device="cpu", max_slots=2, num_blocks=64,
                block_size=4, prefill_chunk=4)
    _set()
    # flipping the flags after construction changes neither engine
    assert off.prefix_cache is None and not off.chunked_prefill
    assert off.cache.pools[0].k.dtype == torch.float32
    assert on.prefix_cache is not None and on.chunked_prefill
    assert on.cache.pools[0].k.dtype == torch.int8
    for eng in (off, on):
        ids = [eng.add_request(p, max_new_tokens=4) for p in prompts]
        eng.run()
        assert all(len(eng.output(i)) == 4 for i in ids)
    assert off.stats()["mixed_steps"] == 0 < on.stats()["mixed_steps"]
    assert off.stats()["prefill_chunks"] == 0 < on.stats()["prefill_chunks"]


def test_prefill_chunk_must_be_positive(models):
    with pytest.raises(ValueError, match="prefill_chunk"):
        Engine(models[1], device="cpu", prefill_chunk=0)
