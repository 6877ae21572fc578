"""Weight-only int8 decode (``FLAGS_serving_quant_weights``) against the
reference.

- The weight codec (``block_scales``, ``quantize_int8_block``,
  ``weight_block``, ``quantize_int8_weight``, ``dequantize_int8_weight``)
  gives the reference's int8 planes and fp32 scales bit for bit, at
  ``b = 256``, ``b = 128`` and the one-scale-per-column fallback, with
  zero and non-finite columns.
- ``int8_weight_matmul``'s CPU path (its plain version) agrees with the
  reference's ``x @ dequantize_int8_weight`` (jnp, 'highest') within
  1e-5 x max|y| (fp32 sums in another order), and the wrapper refuses a
  tensor that is on neither the CPU nor a card.
- The engine with the flag gives the JAX engine's greedy tokens and
  counters, per flag combination (off, prefix, chunked, prefix + chunked
  + int8 KV; never across combinations: ROADMAP C.1), quantizes the same
  projections (7 a layer, 3 with the fused QKV and gate/up projections),
  latches the flag at construction, and multiplies every quantized
  projection through ``int8_weight_matmul`` in decode and mixed steps
  only.
"""
import itertools

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
                                   (16, 100, 12), (3, 2048, 40)])
def test_int8_weight_matmul_matches_reference(m, k, n):
    rng = np.random.RandomState(m + k)
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


def test_w8_plan():
    """The split plan fills the card once and keeps every chunk within the
    kernel's shared-memory stage (ints only: shapes, never tensors)."""
    for m, n, k in itertools.product((1, 16, 256, 4096), (24, 2048, 5504),
                                     (36, 2048, 5504)):
        chunk, splits = quant.w8_plan(m, n, k)
        assert chunk * splits >= k > chunk * (splits - 1)
        assert chunk <= quant.W8_MAX_CHUNK
        tiles = -(-n // quant.W8_TN) * -(-m // quant.W8_TM)
        if k > quant.W8_MAX_CHUNK and splits > -(-k // quant.W8_MAX_CHUNK):
            assert tiles * (splits - 1) < quant.W8_WAVE
    assert quant.w8_plan(16, 2048, 2048) == (128, 16)
    assert quant.w8_plan(256, 2048, 5504) == (918, 6)


def test_kernel_source_matches_its_wrapper():
    """What the CPU cannot run, read from the source: the ctypes
    signature of ``pt_w8_gemm`` and the tiling constants ``w8_plan``
    assumes, and the build registers the source."""
    import re
    from pathlib import Path

    from paddle_tpu_torch import _build

    src = (Path(_build.CSRC) / "w8_gemm.cu").read_text()
    assert "w8_gemm" in _build.SOURCES
    proto = re.search(r"int pt_w8_gemm\(([^)]*)\)", src).group(1)
    kinds = ["p" if "*" in a else "i" for a in proto.split(",")]
    want = ["p" if t is quant._P else "i"
            for t in quant._SIGNATURES["pt_w8_gemm"]]
    assert kinds == want
    consts = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", src))
    assert int(consts["kBM"]) == quant.W8_TM
    assert consts["kTN"] == "32 * kCols" and int(consts["kCols"]) * 32 \
        == quant.W8_TN
    assert int(consts["kMaxChunk"]) == quant.W8_MAX_CHUNK
    # no float atomics: the split partials are summed in a fixed order
    assert re.findall(r"atomicAdd\((\w+)", src) == ["counters"]


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
