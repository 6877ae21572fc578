"""bf16 serving: the port's engine on a bfloat16 Llama against the JAX
engine on the same bfloat16 weights, and the int8-weight GEMM's bf16 mode.

Both engines get the tiny Llama's weights (copied through
``load_jax_state``; bf16 values widen to float32 exactly and narrow back)
and the same requests, with every tier-2 flag off, prefix cache + chunked
prefill, int8 KV pages, and int8 weights; each combination is held only
against the JAX engine under the SAME combination. The port runs on the
CPU, which takes each kernel's plain version.

The greedy-token rule is ``chip_smoke.py`` phase 10(b)'s: the two
engines' tokens are equal, or first diverge where the port's top-2 logit
gap (dense bf16 logits of the prompt and the agreed tokens) is under
``BF16_NEAR_TIE`` x the row's max |logit|. Both packages round every
activation to bf16 but at other places (XLA's fusions against eager
PyTorch), so logits move by a few bf16 ulps; nothing is compared after a
first divergence.

The plain int8-weight GEMM with bf16 ``x`` is the reference's
``x @ dequantize_int8_weight(q, s, bfloat16)``: its output is bf16 and
within one bf16 ulp of the reference's (both sum exact bf16 x bf16
products in fp32, in another order, and round once). A source check holds
the wrapper's ctypes signature for the bf16 mode against the C entry
point in ``csrc/w8_gemm.cu``.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import serving as jax_serving
from paddle_tpu.core import flags as jax_flags
from paddle_tpu.kernels import quant as jax_quant
from paddle_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig,
    LlamaForCausalLM as JaxLlamaForCausalLM,
)
from paddle_tpu_torch import _build
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.kernels import quant
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM, \
    load_jax_state
from paddle_tpu_torch.serving import Engine

BF16_NEAR_TIE = 2.0 ** -4
FLAG_NAMES = ("FLAGS_serving_prefix_cache", "FLAGS_serving_chunked_prefill",
              "FLAGS_serving_quant_kv", "FLAGS_serving_quant_weights")
COMBOS = [pytest.param((False, False, False, False), id="flags_off"),
          pytest.param((True, True, False, False), id="prefix-chunked"),
          pytest.param((False, False, True, False), id="quant_kv"),
          pytest.param((False, False, False, True), id="quant_weights")]
TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=128)
GEOMETRY = dict(max_slots=4, block_size=8, num_blocks=64, prefill_chunk=8)


def _set(values):
    d = dict(zip(FLAG_NAMES, values))
    jax_flags.set_flags(d)
    flags.set_flags(d)


@pytest.fixture(autouse=True)
def _restore_flags():
    yield
    _set((False,) * 4)


@pytest.fixture(scope="module")
def models():
    paddle.seed(3)
    jmodel = JaxLlamaForCausalLM(JaxLlamaConfig(use_parallel=False,
                                                dtype="bfloat16", **TINY))
    names, values = jmodel.functional_state()
    model = LlamaForCausalLM(LlamaConfig(dtype="bfloat16", **TINY),
                             device="cpu")
    load_jax_state(model, names,
                   [np.asarray(v, dtype=np.float32) for v in values])
    return jmodel, model


def _prompts():
    """Buckets 8, 16 and 64, then a prompt sharing 40 tokens (5 full
    pages) with the longest, served after the first three finished."""
    rng = np.random.RandomState(11)
    first = [rng.randint(0, 64, (n,)).tolist() for n in (5, 13, 50)]
    return first, [first[2][:40] + rng.randint(0, 64, (6,)).tolist()]


def _serve(make, values):
    _set(values)
    eng = make(**GEOMETRY)
    first, second = _prompts()
    ids = [eng.add_request(p, max_new_tokens=8) for p in first]
    eng.run()
    ids += [eng.add_request(p, max_new_tokens=8) for p in second]
    eng.run()
    return [eng.output(i) for i in ids], eng.stats()


def _near_tie(model, prompt, want, got):
    """True when equal; else the first divergence's top-2 gap (the port's
    dense bf16 logits) must be under BF16_NEAR_TIE x max|logit|."""
    if got == want:
        return True
    i = next((j for j, (a, b) in enumerate(zip(want, got)) if a != b),
             min(len(want), len(got)))
    with torch.no_grad():
        logits = model(torch.tensor([prompt + want[:i]]))[0, -1].float()
    top2 = logits.topk(2).values
    gap = float(top2[0] - top2[1])
    assert gap < BF16_NEAR_TIE * float(logits.abs().max()), (i, gap)
    return False


@pytest.mark.parametrize("values", COMBOS)
def test_bf16_engine_matches_the_jax_engine(models, values):
    jmodel, model = models
    want, jstats = _serve(lambda **kw: jax_serving.Engine(jmodel, **kw),
                          values)
    got, stats = _serve(lambda **kw: Engine(model, device="cpu", **kw),
                        values)
    first, second = _prompts()
    same = [_near_tie(model, p, w, g)
            for p, w, g in zip(first + second, want, got)]
    assert sum(same) >= len(same) - 1, (want, got)
    assert all(len(t) == 8 for t in got)
    if values[0]:
        assert stats["prefix_hit_tokens"] == jstats["prefix_hit_tokens"] > 0
    assert stats["prefill_chunks"] == jstats["prefill_chunks"]


def test_bf16_pools_and_int8_weight_routes(models):
    """The bf16 engine keeps bf16 pools (int8 with fp32 scales under int8
    KV) and bf16 activations through the int8 weight routes."""
    _, model = models
    _set((False, False, False, False))
    eng = Engine(model, device="cpu", **GEOMETRY)
    assert eng.cache.pools[0].k.dtype == torch.bfloat16
    _set((False, False, True, True))
    eng = Engine(model, device="cpu", **GEOMETRY)
    pool = eng.cache.pools[0]
    assert pool.k.dtype == torch.int8 and pool.k_scale.dtype == torch.float32
    q, s = next(iter(eng.quant_weight_table.values()))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    rid = eng.add_request([1, 2, 3], max_new_tokens=3)
    eng.run()
    assert len(eng.output(rid)) == 3


@pytest.mark.parametrize("m,k,n", [(1, 256, 64), (16, 512, 96),
                                   (33, 200, 24), (7, 1000, 40),
                                   (17, 1000, 24), (256, 1000, 24),
                                   (17, 2048, 256), (256, 512, 24)])
def test_plain_bf16_matmul_is_the_references(m, k, n):
    rng = np.random.RandomState(m + k)
    w = (rng.randn(k, n) * 0.05).astype(np.float32)
    x = rng.randn(m, k).astype(np.float32)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    q, s = quant.quantize_int8_weight(wb)
    got = quant.int8_weight_matmul(xb, q, s)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (m, n)
    jw = jax_quant.dequantize_int8_weight(jnp.asarray(q.numpy()),
                                          jnp.asarray(s.numpy()),
                                          jnp.bfloat16)
    jx = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    want = np.asarray((jx @ jw).astype(jnp.float32))
    # the weights dequantize to the same bf16 values bit for bit
    np.testing.assert_array_equal(
        quant.dequantize_int8_weight(q, s, torch.bfloat16).float().numpy(),
        np.asarray(jw.astype(jnp.float32)))
    err = np.abs(got.float().numpy() - want)
    assert (err <= 2.0 ** -7 * np.abs(want)
            + 2.0 ** -16 * np.abs(want).max()).all(), err.max()


def test_bf16_mode_signature_matches_the_c_entry_point():
    src = (Path(_build.CSRC) / "w8_gemm.cu").read_text()
    for fn in ("pt_w8_gemm", "pt_w8_gemm_bf16", "pt_w8_gemm_f16"):
        proto = re.search(r"int %s\(([^)]*)\)" % fn, src).group(1)
        kinds = ["p" if "*" in a else "i" for a in proto.split(",")]
        assert kinds == ["p" if t is quant._P else "i"
                         for t in quant._SIGNATURES[fn]]
    # each dtype reaches its own entry point, and the bf16 and float16 ones
    # the tensor-core kernels' dispatch (bf16 or __half pointers), never
    # the fp32 mode's
    assert quant._ENTRY == {torch.float32: "pt_w8_gemm",
                            torch.bfloat16: "pt_w8_gemm_bf16",
                            torch.float16: "pt_w8_gemm_f16"}
    for fn, tx in (("pt_w8_gemm_bf16", "bf16"), ("pt_w8_gemm_f16", "__half")):
        body = re.search(r"int %s\([^)]*\)\s*\{(.*?)\n\}" % fn, src,
                         re.S).group(1)
        assert "w8_gemm_tc<%s>(x" % tx in body
    body = re.search(r"int w8_gemm_tc\([^)]*\)\s*\{(.*?)\n\}", src,
                     re.S).group(1)
    assert "dispatch_tc<true>(xt" in body
    assert "dispatch_tc<false>(xt" in body
    assert "static_cast<const TX*>(x)" in body
    assert re.search(r"\bdispatch<", body) is None
    assert "typedef __nv_bfloat16 bf16;" in src


class _FakeLib:
    """Stands in for the built w8_gemm library: records each call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("pt_w8_gemm"):
            raise AttributeError(name)

        def call(*args):
            self.calls.append(name)
            return 0
        return call


def test_cuda_tensors_reach_the_entry_point_of_their_dtype(monkeypatch):
    """Fake CUDA tensors (no card here): float32 x reaches pt_w8_gemm,
    bfloat16 x pt_w8_gemm_bf16 with a bf16 output and float16 x
    pt_w8_gemm_f16 with a float16 output; all count in ``launches``, the
    bf16 one in ``bf16_launches`` and the float16 one in ``f16_launches``;
    a float64 x raises. The plain version never runs for CUDA tensors."""
    import warnings

    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran for CUDA tensors")

    lib = _FakeLib()
    monkeypatch.setattr(quant, "_lib", lib)
    monkeypatch.setattr(_build, "stream_handle", lambda device: None)
    monkeypatch.setattr(quant, "int8_weight_matmul_reference", no_plain)
    before = (quant.launches, quant.bf16_launches, quant.f16_launches)
    with FakeTensorMode(), warnings.catch_warnings():
        warnings.simplefilter("ignore")   # FakeTensor.data_ptr()
        q = torch.empty(2048, 256, dtype=torch.int8, device="cuda")
        s = torch.empty(8, 256, device="cuda")
        y32 = quant.int8_weight_matmul(torch.empty(16, 2048, device="cuda"),
                                       q, s)
        y16 = quant.int8_weight_matmul(
            torch.empty(2, 8, 2048, dtype=torch.bfloat16, device="cuda"), q,
            s)
        yh = quant.int8_weight_matmul(
            torch.empty(16, 2048, dtype=torch.float16, device="cuda"), q, s)
        with pytest.raises(ValueError, match="bfloat16 or float16 x"):
            quant.int8_weight_matmul(
                torch.empty(16, 2048, dtype=torch.float64, device="cuda"), q,
                s)
    assert y32.dtype == torch.float32 and y16.dtype == torch.bfloat16
    assert yh.dtype == torch.float16 and tuple(yh.shape) == (16, 256)
    assert tuple(y16.shape) == (2, 8, 256)
    assert lib.calls == ["pt_w8_gemm", "pt_w8_gemm_bf16", "pt_w8_gemm_f16"]
    assert (quant.launches, quant.bf16_launches, quant.f16_launches) == (
        before[0] + 3, before[1] + 1, before[2] + 1)
