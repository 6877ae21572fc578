"""Weight-only int8 decode (``FLAGS_serving_quant_weights``) against the
reference.

- The weight codec (``block_scales``, ``quantize_int8_block``,
  ``weight_block``, ``quantize_int8_weight``, ``dequantize_int8_weight``)
  gives the reference's int8 planes and fp32 scales bit for bit, at
  ``b = 256``, ``b = 128`` and the one-scale-per-column fallback, with
  zero and non-finite columns.
- ``int8_weight_matmul``'s CPU path (its plain version) agrees with the
  reference's ``x @ dequantize_int8_weight`` (jnp, 'highest') within
  1e-5 x max|y| (fp32 sums in another order), the fused qkv_proj and
  gate_up_proj shapes included, and the wrapper refuses a tensor that is
  on neither the CPU nor a card.
- The kernel's plan (``w8_plan``) and, read from ``csrc/w8_gemm.cu``, its
  C signature, tile constants, cluster launch and the absence of atomics
  and per-launch scratch.
- The engine with the flag gives the JAX engine's greedy tokens and
  counters, per flag combination (off, prefix, chunked, prefix + chunked
  + int8 KV; never across combinations: ROADMAP C.1), quantizes the same
  projections (7 a layer, 3 with the fused QKV and gate/up projections),
  latches the flag at construction, and multiplies every quantized
  projection through ``int8_weight_matmul`` in decode and mixed steps
  only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import serving as jax_serving
from paddle_tpu.core import flags as jax_flags
from paddle_tpu.kernels import quant as jquant
from paddle_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig,
    LlamaForCausalLM as JaxLlamaForCausalLM,
)
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.kernels import quant
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM, \
    load_jax_state
from paddle_tpu_torch.serving import Engine
from torch_threads import one_torch_thread  # noqa: F401

FLAG_NAMES = ("FLAGS_serving_prefix_cache", "FLAGS_serving_chunked_prefill",
              "FLAGS_serving_quant_kv", "FLAGS_serving_quant_weights")
COMBOS = [pytest.param((False, False, False), id="quant_w"),
          pytest.param((True, False, False), id="prefix-quant_w"),
          pytest.param((False, True, False), id="chunked-quant_w"),
          pytest.param((True, True, True), id="prefix-chunked-quant_kv-w")]
COUNTERS = ("requests_finished", "preemptions", "prefill_runs",
            "decode_steps", "output_tokens", "finished_output_tokens",
            "prefix_hit_tokens", "cow_clones", "prefill_chunks",
            "kv_quant_pages")
# the tiny Llama of tests/test_serving_quant.py (every weight one block)
TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=64)
# wide enough for several scale blocks a column: hidden 512 (b = 256, two
# blocks), FFN 384 (down_proj: b = 128, three blocks)
BLOCKS = dict(vocab_size=64, hidden_size=512, intermediate_size=384,
              num_hidden_layers=2, num_attention_heads=4,
              max_position_embeddings=64)
PROJECTIONS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
               "up_proj", "down_proj")


def _set(prefix=False, chunked=False, quant_kv=False, quant_weights=False):
    values = dict(zip(FLAG_NAMES, (prefix, chunked, quant_kv,
                                   quant_weights)))
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
def tiny():
    return _pair(0, **TINY)


@pytest.fixture(scope="module")
def blocks():
    return _pair(1, **BLOCKS)


# ---------------------------------------------------------------------------
# the codec and the product
# ---------------------------------------------------------------------------

def _weight(rng, shape):
    w = (rng.randn(*shape) * 0.05).astype(np.float32)
    w[:, 1] = 0.0                        # an all-zero column: scale 1.0
    w[3, 2] = np.nan                     # poisons its column's block
    w[shape[0] - 1, 4] = -np.inf
    # ties: values landing on .5 after the divide round half to even
    w[0:4, 5] = [0.5, 1.5, 2.5, 127.0]
    w[4:, 5] = 0.0
    return w


@pytest.mark.parametrize("shape,block", [((512, 24), 256), ((384, 16), 128),
                                         ((100, 12), 100), ((36, 8), 36)],
                         ids=["b256", "b128", "fallback100", "fallback36"])
def test_weight_codec_bit_for_bit(shape, block):
    w = _weight(np.random.RandomState(shape[0]), shape)
    assert quant.weight_block(shape[0]) == jquant.weight_block(shape[0]) \
        == block
    jq, js = (np.asarray(a) for a in jquant.quantize_int8_weight(
        jnp.asarray(w)))
    q, s = quant.quantize_int8_weight(torch.from_numpy(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(q.shape) == shape
    assert tuple(s.shape) == (shape[0] // block, shape[1])
    np.testing.assert_array_equal(s.numpy(), js)         # NaN == NaN here
    np.testing.assert_array_equal(q.numpy(), jq)
    assert (s.numpy()[:, 1] == 1.0).all() and (q.numpy()[:, 1] == 0).all()
    assert np.isnan(s.numpy()[0, 2]) and np.isnan(s.numpy()[-1, 4])
    if block == shape[0]:
        assert q.numpy()[0:4, 5].tolist() == [0, 2, 2, 127]
    deq = quant.dequantize_int8_weight(q, s).numpy()
    jdeq = np.asarray(jquant.dequantize_int8_weight(jnp.asarray(jq),
                                                    jnp.asarray(js)))
    np.testing.assert_array_equal(deq, jdeq)
    half = quant.dequantize_int8_weight(q, s, torch.bfloat16)
    assert half.dtype == torch.bfloat16


@pytest.mark.parametrize("block", [256, 64, 8])
def test_block_codec_bit_for_bit(block):
    rng = np.random.RandomState(block)
    x = rng.randn(6, 512).astype(np.float32)
    x[2, :block] = 0.0
    x[4, 7] = np.inf
    np.testing.assert_array_equal(
        quant.block_scales(torch.from_numpy(x), block).numpy(),
        np.asarray(jquant.block_scales(jnp.asarray(x), block)))
    jq, js = jquant.quantize_int8_block(jnp.asarray(x), block)
    q, s = quant.quantize_int8_block(torch.from_numpy(x), block)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    with pytest.raises(ValueError, match="block"):
        quant.block_scales(torch.from_numpy(x[:, :100]), 64)


@pytest.mark.parametrize("m,k,n", [(1, 512, 24), (5, 384, 16),
                                   (16, 100, 12), (3, 2048, 40),
                                   (2, 2048, 6144), (1, 2048, 11008)],
                         ids=["b256", "b128", "fallback100", "k2048",
                              "qkv_proj", "gate_up_proj"])
def test_int8_weight_matmul_matches_reference(m, k, n):
    rng = np.random.RandomState(m + k + n)
    w = (rng.randn(k, n) * 0.05).astype(np.float32)
    x = rng.randn(2, m, k).astype(np.float32)
    jq, js = jquant.quantize_int8_weight(jnp.asarray(w))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jnp.asarray(x)
                          @ jquant.dequantize_int8_weight(jq, js))
    got = quant.int8_weight_matmul(torch.from_numpy(x),
                                   torch.from_numpy(np.array(jq)),
                                   torch.from_numpy(np.array(js)))
    assert tuple(got.shape) == (2, m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_int8_weight_matmul_never_falls_back():
    q, s = quant.quantize_int8_weight(torch.randn(64, 8))
    x = torch.randn(3, 64)
    launches = quant.launches
    with pytest.raises(ValueError, match="one CUDA device or all on the "
                                         "CPU"):
        quant.int8_weight_matmul(x.to("meta"), q.to("meta"), s.to("meta"))
    with pytest.raises(ValueError, match="do not fit"):
        quant.int8_weight_matmul(torch.randn(3, 32), q, s)
    assert quant.launches == launches   # the plain path counts nothing


# llama1b's projections (K -> N), the fused qkv_proj and gate_up_proj, an N
# off the vector path and the one-scale-per-column fallback block
PLAN_SHAPES = [(2048, 2048), (2048, 5504), (5504, 2048), (2048, 6144),
               (2048, 11008), (2048, 24), (36, 24)]


@pytest.mark.parametrize("m", [1, 5, 16, 17, 64, 256, 4096])
@pytest.mark.parametrize("k,n", PLAN_SHAPES,
                         ids=["%d-%d" % s for s in PLAN_SHAPES])
def test_w8_plan(m, k, n):
    """The plan is integers from the shapes alone; it takes the cluster
    split-K regime exactly at M <= W8_SMALL_M; its grid covers every
    output tile once and every k row once (per split and, in the small
    regime, per warp); a cluster holds at most W8_MAX_CLUSTER CTAs."""
    plan = quant.w8_plan(m, n, k)
    assert all(type(v) is int for v in plan)
    bm, chunk, splits = plan
    small = m <= quant.W8_SMALL_M
    assert (bm == quant.W8_SMALL_BM) == small
    assert small or bm in quant.W8_LARGE_BM
    bn = quant.W8_SMALL_BN if small else quant.W8_LARGE_BN
    granule = quant.W8_SMALL_KT if small else quant.W8_KT
    assert chunk % granule == 0 and 1 <= splits <= quant.W8_MAX_CLUSTER
    assert splits == -(-k // chunk)
    assert splits == 1 or chunk >= quant.W8_MIN_CHUNK
    # the grid (splits, ceil(N / bn), ceil(M / bm)): each output element
    # in exactly one tile
    cover = np.zeros((m, n), np.int32)
    for ty in range(-(-m // bm)):
        for tx in range(-(-n // bn)):
            cover[ty * bm:(ty + 1) * bm, tx * bn:(tx + 1) * bn] += 1
    assert (cover == 1).all()
    # each k row in exactly one split, and one warp's run of it
    rows = np.zeros(k, np.int32)
    for z in range(splits):
        lo, hi = z * chunk, min(k, (z + 1) * chunk)
        assert lo < hi
        if small:
            per = chunk // quant.W8_SMALL_WARPS
            assert per % 8 == 0
            for w in range(quant.W8_SMALL_WARPS):
                b = min(k, lo + w * per)
                rows[b:min(k, b + per)] += 1
        else:
            rows[lo:hi] += 1
    assert (rows == 1).all()
    # the cost model's clusters fit what the card schedules at once
    assert len(quant.W8_CLUSTER_SMS) == quant.W8_MAX_CLUSTER


def _source():
    from pathlib import Path

    from paddle_tpu_torch import _build
    return (Path(_build.CSRC) / "w8_gemm.cu").read_text()


def _consts(src):
    import re
    return dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", src))


def _source_signature():
    """The C entry points' argument kinds against the wrapper's ctypes."""
    import re
    for fn, argtypes in quant._SIGNATURES.items():
        proto = re.search(r"int %s\(([^)]*)\)" % fn, _source()).group(1)
        kinds = ["p" if "*" in a else "i" for a in proto.split(",")]
        assert kinds == ["p" if t is quant._P else "i" for t in argtypes]


def _source_constants():
    """The tile constants the plan assumes are the source's."""
    c = _consts(_source())
    assert int(c["kSmallBM"]) == quant.W8_SMALL_BM
    assert int(c["kSmallBN"]) == quant.W8_SMALL_BN
    assert int(c["kSmallWarps"]) == quant.W8_SMALL_WARPS
    assert int(c["kSmallWarps"]) * int(c["kSmallRows"]) == quant.W8_SMALL_KT
    assert c["kSmallKT"] == "kSmallWarps * kSmallRows"
    assert int(c["kKT"]) == quant.W8_KT
    assert int(c["kMaxCluster"]) == quant.W8_MAX_CLUSTER
    assert int(c["kLargeBN"]) == quant.W8_LARGE_BN


def _source_no_float_atomics():
    """No atomics at all: the split partials meet in shared memory, in a
    fixed order, so two launches give the same bits."""
    import re
    src = _source()
    assert re.search(r"\batomic\w*\s*\(", src) is None
    assert "map_shared_rank" in src and src.count("cluster.sync();") == 2


def _source_cluster_limit():
    """A cluster of more than 8 CTAs needs the non-portable attribute; the
    source sets it before any cluster launch."""
    src = _source()
    assert quant.W8_MAX_CLUSTER <= 16
    if quant.W8_MAX_CLUSTER > 8:
        assert "cudaFuncAttributeNonPortableClusterSizeAllowed" in src
    assert "cudaLaunchAttributeClusterDimension" in src
    assert "cudaOccupancyMaxActiveClusters" in src


def _source_no_scratch():
    """The wrapper allocates its output and nothing else a launch, and the
    C entry takes no scratch pointer."""
    import ast
    import inspect
    import textwrap

    tree = ast.parse(textwrap.dedent(inspect.getsource(
        quant.int8_weight_matmul)))
    allocs = [n.func.attr for n in ast.walk(tree)
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
              and n.func.attr in ("empty", "zeros", "full", "empty_like",
                                  "zeros_like", "new_empty", "new_zeros")]
    assert allocs == ["empty"]
    assert quant._SIGNATURES["pt_w8_gemm"].count(quant._P) == 5  # x q s y st
    assert not hasattr(quant, "_counters")


def _source_built():
    """The build compiles the source and hashes every csrc/ header it
    includes (the bf16 mode's mma.sync and wgmma building blocks), so an
    edit to one rebuilds the kernels."""
    import re

    from paddle_tpu_torch import _build
    assert "w8_gemm" in _build.SOURCES
    includes = re.findall(r'#include "([^"]+)"', _source())
    assert includes == ["mma_bf16.cuh", "wgmma_bf16.cuh"]
    assert _build.HEADERS["w8_gemm"] == tuple(includes)


SOURCE_CHECKS = {"signature": _source_signature,
                 "constants": _source_constants,
                 "no_float_atomics": _source_no_float_atomics,
                 "cluster_limit": _source_cluster_limit,
                 "no_scratch": _source_no_scratch,
                 "built": _source_built}


@pytest.mark.parametrize("check", sorted(SOURCE_CHECKS))
def test_kernel_source_matches_its_wrapper(check):
    """What the CPU cannot run, read from the source and the wrapper."""
    SOURCE_CHECKS[check]()


def test_serving_profile_groups_the_int8_gemm():
    """The profile tool puts the int8-weight GEMM's kernels (both regimes)
    in their own group, apart from the other GEMMs, and latches
    ``--quant-weights`` with the engine's flag."""
    from paddle_tpu_torch.tools import serving_profile

    for name in ("void (anonymous namespace)::small::w8_gemm_small<true>"
                 "(float const*, signed char const*, float const*, "
                 "float*, int, int, int, int, int)",
                 "void (anonymous namespace)::large::w8_gemm_large<128, 8, "
                 "1, true>(float const*, ...)",
                 "void (anonymous namespace)::tc::w8_gemm_mma<1, true>"
                 "(__nv_bfloat16 const*, signed char const*, ...)",
                 "void (anonymous namespace)::wg::w8_gemm_wgmma<2, true>"
                 "(__nv_bfloat16 const*, signed char const*, ...)"):
        assert serving_profile._group(name) == "w8"
    assert serving_profile._group("sm90_xmma_gemm_f32f32_f32f32") == "gemm"
    assert "FLAGS_serving_quant_weights" in serving_profile._FLAGS


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _workload(make):
    """A staggered batch and a starved pool (preempt and resume), with
    sharing prompt heads for the prefix cache."""
    rng = np.random.RandomState(7)
    head = rng.randint(0, 64, (9,)).tolist()
    prompts = [head + rng.randint(0, 64, (n,)).tolist() for n in (3, 6)]
    prompts += [rng.randint(0, 64, (n,)).tolist() for n in (5, 11)]
    eng = make(max_slots=3, num_blocks=64, block_size=4, prefill_chunk=4)
    ids = [eng.add_request(p, max_new_tokens=6) for p in prompts[:3]]
    eng.step()
    ids.append(eng.add_request(prompts[3], max_new_tokens=5))
    eng.run()
    starved = make(max_slots=2, num_blocks=7, block_size=4, prefill_chunk=4)
    sids = [starved.add_request(p, max_new_tokens=10)
            for p in (prompts[2][:6], prompts[3][:8])]
    starved.run()
    return [{"tokens": [e.output(i) for i in ii],
             "counters": {k: e.stats()[k] for k in COUNTERS}}
            for e, ii in ((eng, ids), (starved, sids))]


@pytest.mark.parametrize("combo", COMBOS)
@pytest.mark.parametrize("model", ["tiny", "blocks"])
def test_engine_matches_reference(request, model, combo):
    jmodel, pmodel = request.getfixturevalue(model)
    _set(*combo, quant_weights=True)
    want = _workload(lambda **kw: jax_serving.Engine(jmodel, **kw))
    got = _workload(lambda **kw: Engine(pmodel, device="cpu", **kw))
    assert got == want
    assert got[1]["counters"]["preemptions"] >= 1 or combo[0]


def _names(model, table):
    names = {m: n for n, m in model.named_modules()}
    return sorted(names[m] + ".weight" for m in table)


def test_quantizes_the_reference_projections(blocks):
    jmodel, pmodel = blocks
    _set(quant_weights=True)
    jeng = jax_serving.Engine(jmodel, max_slots=1, num_blocks=16,
                              block_size=4)
    eng = Engine(pmodel, device="cpu", max_slots=1, num_blocks=16,
                 block_size=4)
    want = sorted(n for n, v in zip(jeng._names, jeng._decode_vals)
                  if isinstance(v, tuple))
    assert len(want) == 7 * BLOCKS["num_hidden_layers"]
    assert _names(pmodel, eng.quant_weight_table) == want
    assert {n.split(".")[-2] for n in want} == set(PROJECTIONS)
    by_name = dict(zip(jeng._names, jeng._decode_vals))
    for module, (q, s) in eng.quant_weight_table.items():
        jq, js = by_name[_names(pmodel, {module: None})[0]]
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        # the fp32 weight stays beside its int8 copy
        assert module.weight.dtype == torch.float32
    # the fused variant: one QKV and one gate/up projection a layer
    fused = LlamaForCausalLM(LlamaConfig(**dict(
        TINY, fuse_attention_qkv=True, fuse_mlp=True)), device="cpu")
    feng = Engine(fused, device="cpu", max_slots=1, num_blocks=16,
                  block_size=4)
    assert {n.split(".")[-2] for n in _names(fused, feng.quant_weight_table)} \
        == {"qkv_proj", "o_proj", "gate_up_proj", "down_proj"}
    assert len(feng.quant_weight_table) == 4 * TINY["num_hidden_layers"]


def test_flag_latched_at_construction(tiny):
    _, model = tiny
    off = Engine(model, device="cpu", max_slots=1, num_blocks=16,
                 block_size=4)
    _set(quant_weights=True)
    on = Engine(model, device="cpu", max_slots=1, num_blocks=16,
                block_size=4)
    _set()
    assert not off.quant_weights and off.quant_weight_table == {}
    assert on.quant_weights and len(on.quant_weight_table) == 14
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    outs = []
    for eng in (off, on):
        rid = eng.add_request(prompt, max_new_tokens=5)
        outs.append(eng.run()[rid])
    assert len(outs[0]) == len(outs[1]) == 5


@pytest.mark.parametrize("chunked", [False, True], ids=["decode", "mixed"])
def test_int8_product_only_in_decode_and_mixed_steps(tiny, chunked,
                                                     monkeypatch):
    """Every quantized projection of every decode (or mixed) step goes
    through int8_weight_matmul (7 x 2 layers a step); prefill keeps the
    fp32 weights; the flag off never reaches it."""
    _, model = tiny
    calls = []
    real = quant.int8_weight_matmul_reference

    def counted(x, q, s):
        calls.append(tuple(x.shape))
        return real(x, q, s)
    monkeypatch.setattr(quant, "int8_weight_matmul_reference", counted)
    _set(chunked=chunked)
    off = Engine(model, device="cpu", max_slots=2, num_blocks=32,
                 block_size=4, prefill_chunk=4)
    off.add_request([1, 2, 3, 4, 5], max_new_tokens=4)
    off.run()
    assert calls == []
    _set(chunked=chunked, quant_weights=True)
    eng = Engine(model, device="cpu", max_slots=2, num_blocks=32,
                 block_size=4, prefill_chunk=4)
    eng.add_request([1, 2, 3, 4, 5], max_new_tokens=4)
    eng.add_request([6, 7], max_new_tokens=3)
    eng.run()
    steps = eng.stats()["decode_steps"]
    assert len(calls) == 7 * TINY["num_hidden_layers"] * steps > 0
    rows = 2 * 4 if chunked else 2           # max_slots x (chunk or 1)
    assert {c[0] * c[1] for c in calls} == {rows}
