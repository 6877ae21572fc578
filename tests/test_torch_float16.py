"""The port's float16 model against the JAX package, on the CPU.

The reference's kernels take any float dtype, so a float16 Llama reaches
its fused lm_head + CE kernels (4-6) when it trains with
``FLAGS_fused_lm_head_ce`` and its paged attention kernels (7-8) when
``serving.Engine`` serves it; its weight-only int8 decode dequantizes to
float16 (the port's kernel 10 in its float16 mode). Here every tensor lies
on the CPU, so each wrapper runs its plain version, held against:

- the fused CE plain version (loss, lse, dh, dW) against ``_pallas_fwd``
  / ``_pallas_bwd`` in interpret mode at T = 256, H = 64, V = 1000, at an
  unscaled g = 1 / T, at GradScaler's 2^15 and at a scale that overflows
  float16: zeros, infs and NaNs of dh and dW in the same places;
- the paged decode and mixed plain versions in float16, and over int8
  pages under float16 queries, against the Pallas kernels in interpret
  mode;
- kernel 10's plain float16 version against the reference's
  ``dequantize_int8_weight(q, s, float16)`` then a float16 matmul;
- a 2-layer float16 Llama: its parameters carried across bit for bit, two
  fused-tail steps through ``TrainStep(labels_to_model=True)`` against
  the reference's ``CompiledTrainStep``, and its greedy tokens through
  both engines under the tier-2 flags;
- fake CUDA tensors: float16 reaches dtype code 3 and each kernel's C
  entry point, and never the plain version.

Every reference program is compiled with XLA's excess precision off, as
``tests/test_torch_amp.py`` does: by default XLA keeps the float32 value
across a float32 -> float16 -> float32 round trip inside one program,
where the reference's own rounding points (``dl.astype(w.dtype)``) and
the port round.

Tolerances. Fused CE: loss and lse agree to float32 rounding (rtol and
atol 1e-5; XLA's CPU exp is an approximation within ~1e-5). dl is rounded
to float16 at the same point on both sides, but a p one float32 ulp (or
one XLA exp error) apart may round to the neighbouring float16, and dh
and dW are float16 themselves: rtol 2.5e-3 and atol 2.5e-3 x max|grad|,
at least one float16 subnormal step (2^-24), for the finite entries (a
quarter of the bf16 tests' 1e-2: float16 keeps 11 bits to bf16's 8).
Paged: both sides compute in float32 from the same float16 or int8
values, but the plain version is the reference's jnp form, which rounds
the probabilities to float16 before the last product where the Pallas
kernel keeps them in float32: atol 2e-3, rtol 2e-3 (a few float16 ulps of
outputs below 1). Kernel 10: one float16 ulp of the value (2^-10 |y|)
plus 2^-16 max|y| (both sum exact float16 products in float32 in another
order and round once). The trained model: losses rtol 1e-3 (float16
rounds every activation, eager against compiled). Greedy tokens: equal,
or first diverging where the port's top-2 gap is under 2^-7 of the row's
max |logit| (a few float16 ulps).
"""
import re
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as paddle
from paddle_tpu import serving as jax_serving
from paddle_tpu.core import flags as jax_flags
from paddle_tpu.kernels import quant as jax_quant
from paddle_tpu.kernels.fused_ce import _pallas_bwd, _pallas_fwd
from paddle_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig,
    LlamaForCausalLM as JaxLlamaForCausalLM,
)
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.parallel.engine import CompiledTrainStep
from paddle_tpu.serving.kernels.paged_attention import (
    mixed_paged_attention_kernel,
    paged_attention_kernel,
)
from paddle_tpu_torch import _build
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.kernels import fused_ce as fc
from paddle_tpu_torch.kernels import quant
from paddle_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    export_state,
    load_jax_state,
)
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel import TrainStep
from paddle_tpu_torch.serving import Engine
from paddle_tpu_torch.serving.kernels import paged_attention as pa
from torch_threads import one_torch_thread  # noqa: F401

CSRC = Path(_build.CSRC)
FCE_LOSS = dict(rtol=1e-5, atol=1e-5)
FCE_GRAD = dict(rtol=2.5e-3, scale=2.5e-3, floor=2.0 ** -24)
PAGED = dict(atol=2e-3, rtol=2e-3)
LOSS_RTOL = 1e-3
NEAR_TIE = 2.0 ** -7
FLAG_NAMES = ("FLAGS_serving_prefix_cache", "FLAGS_serving_chunked_prefill",
              "FLAGS_serving_quant_kv", "FLAGS_serving_quant_weights")


def _compiled(fn, *args):
    """``fn(*args)`` compiled without XLA's excess precision."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


class _NoExcessPrecision:
    """A jitted function whose first call compiles it without XLA's excess
    precision (``CompiledTrainStep._compiled``)."""

    def __init__(self, jitted):
        self.jitted, self.exe = jitted, None

    def __call__(self, *args):
        if self.exe is None:
            self.exe = self.jitted.lower(*args).compile(
                compiler_options={"xla_allow_excess_precision": False})
        return self.exe(*args)


def _finite_close(got, want, rtol, scale, floor):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    for what, test in (("inf", np.isinf), ("nan", np.isnan),
                       ("zero", lambda x: x == 0)):
        np.testing.assert_array_equal(test(got), test(want), err_msg=what)
    ok = np.isfinite(want)
    if ok.any():
        atol = max(scale * float(np.abs(want[ok]).max()), floor)
        np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=atol)


# -- kernels 4-6: the fused CE plain version ----------------------------------

@pytest.mark.parametrize("scale", [1.0, 2.0 ** 15, 2.0 ** 40],
                         ids=["unscaled", "scaler_default", "overflowing"])
def test_fused_ce_plain_matches_pallas_in_float16(scale):
    t_len, hid, vocab = 256, 64, 1000
    rng = np.random.RandomState(5)
    h = rng.randn(t_len, hid).astype(np.float16)
    w = (rng.randn(hid, vocab) * 0.5).astype(np.float16)
    labels = rng.randint(0, vocab, (t_len,)).astype(np.int32)
    labels[::8] = -100
    safe = np.where(labels == -100, 0, labels).astype(np.int32)
    g = np.where(labels == -100, 0.0, scale / t_len).astype(np.float32)
    jloss, jlse = _compiled(lambda a, b, c: _pallas_fwd(a, b, c, 256, 512,
                                                        True), h, w, safe)
    jdh, jdw = _compiled(lambda a, b, c, d, e: _pallas_bwd(
        a, b, c, d, e, 256, 512, True), h, w, safe, jlse, g)
    th, tw, tl = (torch.from_numpy(x) for x in (h, w, safe))
    loss, lse = fc.fused_lm_head_ce_forward(th, tw, tl)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), **FCE_LOSS)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **FCE_LOSS)
    # both sides from the reference's lse: the masks compare rounding only
    dh, dw = fc.fused_lm_head_ce_backward(
        th, tw, tl, torch.from_numpy(np.array(jlse)), torch.from_numpy(g))
    assert dh.dtype == dw.dtype == torch.float16
    _finite_close(dh.float().numpy(), jdh, **FCE_GRAD)
    _finite_close(dw.float().numpy(), jdw, **FCE_GRAD)
    if scale == 1.0:        # p g under float16's smallest subnormal
        assert (dw.numpy() == 0).any() and (dh.numpy() == 0).any()
    if scale == 2.0 ** 40:  # dl at the label past 65504
        assert not np.isfinite(dh.numpy()).all()


# -- kernels 7-8: the paged plain versions ------------------------------------

def _pools(seed, nb, bs, hkv, d, totals):
    """float16 histories of ``totals[s]`` tokens on shuffled pages."""
    rng = np.random.RandomState(seed)
    kp = rng.randn(nb, bs, hkv, d).astype(np.float16)
    vp = rng.randn(nb, bs, hkv, d).astype(np.float16)
    mb = max(-(-max(totals) // bs), 1)
    ids = list(rng.permutation(nb - 1) + 1)
    bt = np.zeros((len(totals), mb), np.int32)
    for i, total in enumerate(totals):
        for j in range(-(-total // bs)):
            bt[i, j] = ids.pop()
    return rng, kp, vp, bt


def _pool_kwargs(kp, vp, int8):
    """(pools and scales for the reference, for the port): float16 pools,
    or the reference's int8 pages of them with float32 scales."""
    if not int8:
        return (jnp.asarray(kp), jnp.asarray(vp), {}), \
            (torch.from_numpy(kp), torch.from_numpy(vp), {})
    kq, ks = jax_quant.quantize_int8_page(jnp.asarray(kp))
    vq, vs = jax_quant.quantize_int8_page(jnp.asarray(vp))
    port = [torch.from_numpy(np.asarray(x)) for x in (kq, vq, ks, vs)]
    return (kq, vq, dict(k_scale=ks, v_scale=vs)), \
        (port[0], port[1], dict(k_scale=port[2], v_scale=port[3]))


@pytest.mark.parametrize("int8", [False, True], ids=["fp16", "int8"])
def test_paged_decode_plain_matches_pallas_in_float16(int8):
    s, h, hkv, d, bs, nb = 3, 8, 2, 64, 8, 16
    lens = [21, 0, 40]
    rng, kp, vp, bt = _pools(7, nb, bs, hkv, d, lens)
    q = rng.randn(s, h, d).astype(np.float16)
    sl = np.asarray(lens, np.int32)
    (jk, jv, jkw), (tk, tv, tkw) = _pool_kwargs(kp, vp, int8)
    kern = _compiled(lambda *a: paged_attention_kernel(
        *a, interpret=True, **jkw), jnp.asarray(q), jk, jv, bt, sl)
    out = pa.paged_attention(torch.from_numpy(q), tk, tv,
                             torch.from_numpy(bt), torch.from_numpy(sl),
                             **tkw)
    assert out.dtype == torch.float16 and kern.dtype == jnp.float16
    for i in (0, 2):
        np.testing.assert_allclose(out[i].float().numpy(),
                                   np.asarray(kern[i], np.float32), **PAGED)


@pytest.mark.parametrize("int8", [False, True], ids=["fp16", "int8"])
def test_mixed_paged_plain_matches_pallas_in_float16(int8):
    s, c, h, hkv, d, bs, nb = 4, 8, 8, 2, 64, 8, 32
    hist, qlen = [13, 0, 30, 5], [8, 0, 1, 3]
    rng, kp, vp, bt = _pools(8, nb, bs, hkv, d,
                             [a + b for a, b in zip(hist, qlen)])
    q = rng.randn(s, c, h, d).astype(np.float16)
    hl, ql = np.asarray(hist, np.int32), np.asarray(qlen, np.int32)
    (jk, jv, jkw), (tk, tv, tkw) = _pool_kwargs(kp, vp, int8)
    kern = _compiled(lambda *a: mixed_paged_attention_kernel(
        *a, interpret=True, **jkw), jnp.asarray(q), jk, jv, bt, hl, ql)
    out = pa.mixed_paged_attention(
        torch.from_numpy(q), tk, tv, *(torch.from_numpy(x)
                                       for x in (bt, hl, ql)), **tkw)
    assert out.dtype == torch.float16
    for i in range(s):
        np.testing.assert_allclose(
            out[i, :qlen[i]].float().numpy(),
            np.asarray(kern[i, :qlen[i]], np.float32), **PAGED)


# -- kernel 10: the int8-weight GEMM's float16 plain version -----------------

@pytest.mark.parametrize("m,k,n", [(1, 256, 64), (16, 512, 96),
                                   (33, 1000, 24), (256, 512, 40)])
def test_plain_float16_matmul_is_the_references(m, k, n):
    rng = np.random.RandomState(m + k)
    w = (rng.randn(k, n) * 0.05).astype(np.float16)
    x = rng.randn(m, k).astype(np.float16)
    q, s = quant.quantize_int8_weight(torch.from_numpy(w))
    got = quant.int8_weight_matmul(torch.from_numpy(x), q, s)
    assert got.dtype == torch.float16 and tuple(got.shape) == (m, n)
    jw = jax_quant.dequantize_int8_weight(jnp.asarray(q.numpy()),
                                          jnp.asarray(s.numpy()),
                                          jnp.float16)
    want = np.asarray(_compiled(lambda a, b: a @ b, jnp.asarray(x), jw),
                      np.float32)
    np.testing.assert_array_equal(   # the same float16 weights, bit for bit
        quant.dequantize_int8_weight(q, s, torch.float16).numpy(),
        np.asarray(jw))
    err = np.abs(got.float().numpy() - want)
    assert (err <= 2.0 ** -10 * np.abs(want)
            + 2.0 ** -16 * np.abs(want).max()).all(), err.max()


# -- the 2-layer float16 Llama ------------------------------------------------

def _jax_llama16():
    """The reference's float16 Llama: its config's dtype (the KV pools'),
    and every parameter cast with ``Layer.to``."""
    paddle.seed(4)
    return JaxLlamaForCausalLM(JaxLlamaConfig.tiny(
        use_parallel=False, num_key_value_heads=2,
        dtype="float16")).to(dtype="float16")


@pytest.fixture(scope="module")
def llama16():
    jmodel = _jax_llama16()
    names, values = jmodel.functional_state()
    values = [np.asarray(v) for v in values]
    model = LlamaForCausalLM(LlamaConfig.tiny(num_key_value_heads=2,
                                              dtype="float16"), device="cpu")
    load_jax_state(model, names, values)
    return jmodel, names, values, model


def test_float16_parameters_carry_across_bit_for_bit(llama16):
    _, names, values, model = llama16
    assert all(v.dtype == np.float16 for v in values)
    assert all(p.dtype == torch.float16 for p in model.parameters())
    got = dict(zip(*export_state(model)))
    for name, value in zip(names, values):
        np.testing.assert_array_equal(got[name].view(np.uint16),
                                      value.view(np.uint16), err_msg=name)


def test_float16_fused_steps_match_compiled_train_step(llama16):
    _, names, values, _ = llama16
    jmodel = _jax_llama16()
    model = LlamaForCausalLM(LlamaConfig.tiny(num_key_value_heads=2,
                                              dtype="float16"), device="cpu")
    load_jax_state(model, names, values)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 256, (4, 64)).astype(np.int32)
    labels = rng.randint(0, 256, (4, 64)).astype(np.int32)
    labels[:, :5] = -100
    jstep = CompiledTrainStep(
        jmodel, None, JaxAdamW(learning_rate=1e-3,
                               parameters=jmodel.parameters()),
        mesh=Mesh(np.array(jax.devices()[:1]), ("dp",)),
        labels_to_model=True)
    jstep._build()
    jstep._compiled = _NoExcessPrecision(jstep._compiled)
    step = TrainStep(model, None, AdamW(1e-3, parameters=model.parameters()),
                     labels_to_model=True, device="cpu")
    calls = []
    forward = fc.fused_lm_head_ce_forward
    flags.set_flags({"FLAGS_fused_lm_head_ce": True})
    jax_flags.set_flags({"FLAGS_fused_lm_head_ce": True})
    try:
        fc.fused_lm_head_ce_forward = \
            lambda *a: calls.append(a[0].dtype) or forward(*a)
        want = [float(jstep(ids, labels)) for _ in range(2)]
        got = [float(step(ids, labels)) for _ in range(2)]
    finally:
        fc.fused_lm_head_ce_forward = forward
        flags.set_flags({"FLAGS_fused_lm_head_ce": False})
        jax_flags.set_flags({"FLAGS_fused_lm_head_ce": False})
    assert calls == [torch.float16] * 2      # the fused tail, in float16
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert all(p.dtype == torch.float16 for p in model.parameters())


def _set(values):
    d = dict(zip(FLAG_NAMES, values))
    jax_flags.set_flags(d)
    flags.set_flags(d)


def _serve(make, values):
    _set(values)
    try:
        eng = make(max_slots=4, block_size=8, num_blocks=64, prefill_chunk=8)
        rng = np.random.RandomState(11)
        first = [rng.randint(0, 256, (n,)).tolist() for n in (5, 13, 50)]
        second = [first[2][:40] + rng.randint(0, 256, (6,)).tolist()]
        ids = [eng.add_request(p, max_new_tokens=6) for p in first]
        eng.run()
        ids += [eng.add_request(p, max_new_tokens=6) for p in second]
        eng.run()
        return first + second, [eng.output(i) for i in ids], eng
    finally:
        _set((False,) * 4)


@pytest.mark.parametrize("values", [
    pytest.param((True, True, True, False), id="prefix-chunked-quant_kv"),
    pytest.param((False, False, False, True), id="quant_weights")])
def test_float16_engine_matches_the_jax_engine(llama16, values):
    """Every tier-2 flag in two runs; the pools and the int8 routes keep
    float16 (int8 pages with float32 scales under int8 KV)."""
    jmodel, _, _, model = llama16
    _, want, _ = _serve(lambda **kw: jax_serving.Engine(jmodel, **kw),
                        values)
    prompts, got, eng = _serve(
        lambda **kw: Engine(model, device="cpu", **kw), values)
    pool = eng.cache.pools[0]
    if values[2]:
        assert pool.k.dtype == torch.int8
        assert pool.k_scale.dtype == torch.float32
    else:
        assert pool.k.dtype == torch.float16
    if values[3]:
        q, s = next(iter(eng.quant_weight_table.values()))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
    same = 0
    for prompt, w, g in zip(prompts, want, got):
        if w == g:
            same += 1
            continue
        i = next(j for j, (a, b) in enumerate(zip(w, g)) if a != b)
        with torch.no_grad():
            logits = model(torch.tensor([prompt + w[:i]]))[0, -1].float()
        top2 = logits.topk(2).values
        assert float(top2[0] - top2[1]) < NEAR_TIE * float(
            logits.abs().max()), (w, g)
    assert same >= len(prompts) - 1, (want, got)
    assert all(len(t) == 6 for t in got)


# -- the CUDA side, with fake CUDA tensors ------------------------------------

class _FakeLib:
    """Stands in for a built library: records each entry point's name and
    arguments."""

    def __init__(self, prefix):
        self.prefix, self.calls = prefix, []

    def __getattr__(self, name):
        if not name.startswith(self.prefix):
            raise AttributeError(name)

        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


def _no_plain(*args, **kwargs):
    raise AssertionError("the plain version ran for CUDA tensors")


def test_float16_is_code_3_in_the_one_table():
    assert _build.DTYPE_CODES == {torch.float32: 0, torch.bfloat16: 1,
                                  torch.float16: 3}
    assert pa.KV_INT8 == 2
    src = (Path(_build.__file__).parent / "kernels"
           / "flash_attention.py").read_text()
    assert "DTYPE_CODES = " not in src


def test_fused_ce_float16_reaches_code_3(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    lib = _FakeLib("pt_fused_ce")
    monkeypatch.setattr(_build, "load", lambda name, sig: lib)
    monkeypatch.setattr(_build, "stream_handle", lambda device: None)
    monkeypatch.setattr(fc, "_sm_count", lambda device: 132)
    for name in ("fused_lm_head_ce_forward_reference",
                 "fused_lm_head_ce_backward_reference"):
        monkeypatch.setattr(fc, name, _no_plain)
    before = (fc.fwd_launches, fc.dh_launches, fc.f16_fwd_launches,
              fc.f16_dh_launches, fc.f16_dw_launches)
    with FakeTensorMode(), warnings.catch_warnings():
        warnings.simplefilter("ignore")   # FakeTensor.data_ptr()
        h = torch.empty(8192, 2048, dtype=torch.float16, device="cuda")
        w = torch.empty(2048, 32000, dtype=torch.float16, device="cuda")
        lab = torch.zeros(8192, dtype=torch.int32, device="cuda")
        g = torch.empty(8192, device="cuda")
        loss, lse = fc.fused_lm_head_ce_forward(h, w, lab)
        dh, dw = fc.fused_lm_head_ce_backward(h, w, lab, lse, g)
        with pytest.raises(ValueError, match="one dtype"):
            fc.fused_lm_head_ce_forward(h, w.bfloat16(), lab)
    assert loss.dtype == torch.float32
    assert dh.dtype == dw.dtype == torch.float16
    names = [n for n, _ in lib.calls]
    chunks = len(fc.chunk_plan(32000))
    assert names == ["pt_fused_ce_fwd"] + [
        "pt_fused_ce_bwd_dl", "pt_fused_ce_bwd_dh",
        "pt_fused_ce_bwd_dw"] * chunks
    assert all(args[-2] == 3 for _, args in lib.calls)   # dtype code 3
    # one split per 256-column tile, the wgmma forward's count
    assert lib.calls[0][1][9] == fc.forward_splits(8192, 32000,
                                                   torch.float16) == 125
    # float16 counts apart from float32 and bf16
    assert (fc.fwd_launches, fc.dh_launches, fc.f16_fwd_launches,
            fc.f16_dh_launches, fc.f16_dw_launches) == (
        before[0], before[1], before[2] + 1, before[3] + 1, before[4] + 1)


def test_fused_ce_float16_entry_points_reach_the_half_kernels():
    text = (CSRC / "fused_ce.cu").read_text()
    entry = text[text.index('extern "C" {'):]
    half = re.findall(r"if \(dtype == 3\)\s*return (\S+)\(", entry)
    assert sorted(half) == ["tc::launch_dh<__half>", "tc::launch_dl<__half>",
                            "tc::launch_dw<__half>", "tc::launch_fwd<__half>"]
    tc = text[text.index("namespace tc {"):text.index("}  // namespace tc")]
    # each launcher's tensor maps name its type; the epilogues store T
    assert tc.count("ptwg::tma_type<T>") == 8
    assert "__floats2bfloat162_rn" not in tc
    assert tc.count("ptwg::store2<T>(") == 3
    assert "typename Epilogue::Elem" in tc


@pytest.mark.parametrize("int8", [False, True], ids=["fp16", "int8"])
def test_paged_float16_reaches_code_3(monkeypatch, int8):
    from torch._subclasses.fake_tensor import FakeTensorMode

    lib = _FakeLib("pt_")
    monkeypatch.setattr(_build, "load", lambda name, sig: lib)
    monkeypatch.setattr(_build, "stream_handle", lambda device: None)
    monkeypatch.setattr(pa, "paged_attention_reference", _no_plain)
    monkeypatch.setattr(pa, "mixed_paged_attention_reference", _no_plain)
    names = ("launches", "int8_launches", "mixed_launches",
             "mixed_int8_launches", "f16_launches", "f16_int8_launches",
             "f16_mixed_launches", "f16_mixed_int8_launches")
    before = {n: getattr(pa, n) for n in names}
    with FakeTensorMode(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pool_dtype = torch.int8 if int8 else torch.float16
        k = torch.empty(64, 16, 16, 128, dtype=pool_dtype, device="cuda")
        v = torch.empty(64, 16, 16, 128, dtype=pool_dtype, device="cuda")
        kw = {}
        if int8:
            kw = dict(k_scale=torch.empty(64, 16, 16, device="cuda"),
                      v_scale=torch.empty(64, 16, 16, device="cuda"))
        bt = torch.zeros(4, 8, dtype=torch.int32, device="cuda")
        lens = torch.ones(4, dtype=torch.int32, device="cuda")
        q = torch.empty(4, 16, 128, dtype=torch.float16, device="cuda")
        out = pa.paged_attention(q, k, v, bt, lens, **kw)
        qm = torch.empty(4, 16, 16, 128, dtype=torch.float16, device="cuda")
        mixed = pa.mixed_paged_attention(qm, k, v, bt, lens, lens, **kw)
        if not int8:
            with pytest.raises(ValueError, match="pools must be q's dtype"):
                pa.paged_attention(q, k.bfloat16(), v.bfloat16(), bt, lens)
    assert out.dtype == mixed.dtype == torch.float16
    assert [n for n, _ in lib.calls] == ["pt_paged_attention",
                                         "pt_mixed_paged_attention"]
    # (dtype, kv_dtype) are the arguments before the stream
    assert [args[-3:-1] for _, args in lib.calls] == \
        [(3, 2 if int8 else 3)] * 2
    mode = "f16_int8" if int8 else "f16"
    after = {n: getattr(pa, n) for n in names}
    assert {n: after[n] - before[n] for n in names} == {
        n: int(n in (mode + "_launches", mode.replace("f16", "f16_mixed")
                     + "_launches")) for n in names}


def test_paged_dispatch_takes_half_queries_and_pools():
    text = (CSRC / "paged_attention.cu").read_text()
    body = text[text.index("cudaError_t dispatch("):]
    body = body[:body.index("\n}\n")]
    assert "dtype == 3 && kv_dtype == 3" in body
    assert "dtype == 3 && kv_dtype == 2" in body
    assert "f(__half{}, __half{}, D128{})" in body
    assert "f(__half{}, int8_t{}, D128{})" in body
    for fn in ("float to_f32(__half", "void store(__half*",
               "float4 ld4(const __half*", "float2 ld2(const __half*"):
        assert fn in text, fn
