"""Head dims beyond 64 and 128: D = 256 (the kernels' new instances) and the
head dims the reference computes with XLA (D = 80, D = 16), against the
reference.

The D = 256 kernels run only on the card (chip_smoke.py phase 18 holds them
against their plain versions there). Here, on the CPU:
  * kernels 1-3's plain versions at D = 256 against the reference's Pallas
    forward and ``jax.vjp`` of it in interpret mode (B = 1, N = 256, H = 2,
    Hkv = 1; causal or not; with segment ids); atol / rtol 1e-4, as
    ``tests/test_torch_bwd_f32.py``'s BWD_TOL (XLA's CPU exp is good to
    ~1e-5 relative and the gradients sum 256 such terms);
  * kernels 7-8's plain versions at D = 256 against the reference's Pallas
    paged kernels in interpret mode, fp32 and int8 pools (1e-5: both
    gather, dequantize and softmax in fp32);
  * a tiny D = 256 Llama (hidden 512, 2 heads, 1 kv head, 2 layers) in
    both packages, weights carried by ``load_jax_state``: logits, one
    step's loss and gradients, and the serving engines' greedy tokens with
    the flags off and with prefix cache + chunked prefill + int8 KV;
  * D = 80 and D = 16: SDPA and both paged paths take the reference's XLA
    computation in plain ops (the head dim alone decides, and the call is
    counted); D >= 384 in 128Z has no kernel and raises on CUDA;
  * ``sparse_attention`` and ``LlamaConfig(tie_word_embeddings=...)``:
    the reference's function, and "Faults of the reference" 23 and 24
    (ROADMAP.md C) raised where the reference ignores its argument.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import paddle_tpu as paddle
import paddle_tpu.nn.functional as jF
from paddle_tpu import serving as jax_serving
from paddle_tpu.core import flags as jax_flags
from paddle_tpu.core.dispatch import no_grad as jax_no_grad
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.kernels.flash_attention import flash_attention as jax_flash
from paddle_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig,
    LlamaForCausalLM as JaxLlamaForCausalLM,
)
from paddle_tpu.serving.kernels.paged_attention import (
    mixed_paged_attention as jax_mixed,
    mixed_paged_attention_kernel as jax_mixed_kernel,
    paged_attention as jax_paged,
    paged_attention_kernel as jax_paged_kernel,
)
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM, \
    load_jax_state
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.serving import Engine
from paddle_tpu_torch.serving.kernels import paged_attention as pa
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
PAGED_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


# -- kernels 1-3 at D = 256 -------------------------------------------------

def _segments(n):
    ids = np.zeros((1, n), np.int32)
    for i, start in enumerate((0, 50, 130, 131, 200)):
        ids[0, start:] = i
    return ids


@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_against_pallas_at_d256(causal, segmented):
    """Output and dq / dk / dv of the plain versions against the
    reference's Pallas forward and ``jax.vjp`` of it (interpret mode), GQA
    2 : 1 (the reference repeats k / v to q's heads: its dk / dv are
    summed over the group here)."""
    b, n, h, hkv, d = 1, 256, 2, 1, 256
    rng = np.random.RandomState(2 * causal + segmented)
    q = rng.randn(b, n, h, d).astype(np.float32)
    k, v = (rng.randn(b, n, hkv, d).astype(np.float32) for _ in range(2))
    g = rng.randn(b, n, h, d).astype(np.float32)
    ids = _segments(n) if segmented else None

    def ref(q_, k_, v_):
        rep = lambda x: jnp.repeat(x, h // hkv, axis=2)   # noqa: E731
        return jax_flash(q_, rep(k_), rep(v_), causal=causal, interpret=True,
                         segment_ids=None if ids is None
                         else jnp.asarray(ids))

    want, vjp = jax.vjp(ref, *(jnp.asarray(x) for x in (q, k, v)))
    want_grads = vjp(jnp.asarray(g))
    tq, tk, tv, tg = _t(q, k, v, g)
    segs = None if ids is None else torch.from_numpy(ids)
    out, lse = fa.flash_attention(tq, tk, tv, causal=causal,
                                  segment_ids=segs)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    grads = fa.flash_attention_backward(tq, tk, tv, out, lse, tg, causal,
                                        segment_ids=segs)
    for got, exp in zip(grads, want_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)


# -- kernels 7-8 at D = 256 -------------------------------------------------

def _pools(seed, lens, hkv, d, bs=16, mb=4, int8=False):
    """Pools holding ``lens[s]`` tokens a slot on shuffled pages (page 0
    the trash page), their tables, and int8 pools with positive scales."""
    rng = np.random.RandomState(seed)
    pages = [-(-n // bs) for n in lens]
    nb = sum(pages) + 1
    ids = list(rng.permutation(np.arange(1, nb)))
    bt = np.zeros((len(lens), mb), np.int32)
    for i, p in enumerate(pages):
        bt[i, :p] = [ids.pop() for _ in range(p)]
    shape = (nb, bs, hkv, d)
    if not int8:
        return rng, dict(k_pool=rng.randn(*shape).astype(np.float32),
                         v_pool=rng.randn(*shape).astype(np.float32)), bt
    kv = {}
    for name in ("k", "v"):
        kv[name + "_pool"] = rng.randint(-127, 128, shape).astype(np.int8)
        kv[name + "_scale"] = rng.uniform(0.005, 0.02, shape[:3]).astype(
            np.float32)
    return rng, kv, bt


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_paged_plain_against_pallas_at_d256(int8):
    h, hkv, d = 8, 1, 256
    lens = [0, 1, 17, 40]
    rng, kv, bt = _pools(0, lens, hkv, d, int8=int8)
    q = rng.randn(len(lens), h, d).astype(np.float32)
    sl = np.asarray(lens, np.int32)
    want = np.asarray(jax_paged_kernel(
        jnp.asarray(q), block_tables=jnp.asarray(bt),
        seq_lens=jnp.asarray(sl), interpret=True,
        **{k: jnp.asarray(x) for k, x in kv.items()}))
    got = pa.paged_attention(*_t(q), block_tables=torch.from_numpy(bt),
                             seq_lens=torch.from_numpy(sl),
                             **dict(zip(kv, _t(*kv.values())))).numpy()
    live = sl > 0
    np.testing.assert_allclose(got[live], want[live], **PAGED_TOL)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_mixed_plain_against_pallas_at_d256(int8):
    h, hkv, d, c = 8, 1, 256, 8
    hist, q_lens = [0, 9, 30, 5], [8, 1, 3, 0]
    rng, kv, bt = _pools(1, [a + b for a, b in zip(hist, q_lens)], hkv, d,
                         int8=int8)
    q = rng.randn(len(hist), c, h, d).astype(np.float32)
    hl, ql = np.asarray(hist, np.int32), np.asarray(q_lens, np.int32)
    want = np.asarray(jax_mixed_kernel(
        jnp.asarray(q), block_tables=jnp.asarray(bt),
        hist_lens=jnp.asarray(hl), q_lens=jnp.asarray(ql), interpret=True,
        **{k: jnp.asarray(x) for k, x in kv.items()}))
    got = pa.mixed_paged_attention(
        *_t(q), block_tables=torch.from_numpy(bt),
        hist_lens=torch.from_numpy(hl), q_lens=torch.from_numpy(ql),
        **dict(zip(kv, _t(*kv.values())))).numpy()
    valid = np.arange(c)[None, :] < ql[:, None]
    np.testing.assert_allclose(got[valid], want[valid], **PAGED_TOL)


def test_split_plan_at_d256():
    """D = 256: 8-row tiles of the mixed rows kernel, 64-row tiles of the
    tiles kernel at any row count, and two rows-kernel CTAs an SM in the
    wave (csrc/paged_attention.cu's MIXED_ROWS<D>, DECODE_CTAS<D>)."""
    rows = pa.split_plan(16, 4, 8, 1, 128, 16, head_dim=256)
    assert (rows.kernel, rows.tile_rows, rows.tiles) == ("rows", 8, 4)
    tall = pa.split_plan(1, 1024, 8, 1, 128, 16, head_dim=256)
    assert (tall.kernel, tall.tile_rows) == ("tiles", 64)
    assert pa.split_plan(1, 1024, 8, 1, 128, 16).tile_rows == 128
    # 16 slots x 1 kv head x 1 tile: 16 CTAs, far below either wave
    dec = pa.split_plan(16, 1, 8, 1, 128, 16, decode=True, head_dim=256)
    assert dec.splits == 128 // pa.SPLIT_PAGES
    # 140 slots fill 2 x 132 slots' wave? no (140 < 264): split; 3 x 132
    # at D = 128 the same
    assert pa.split_plan(270, 1, 8, 1, 128, 16, decode=True,
                         head_dim=256).splits == 1
    assert pa.split_plan(270, 1, 8, 1, 128, 16, decode=True).splits > 1


# -- a tiny D = 256 Llama in both packages ----------------------------------

TINY256 = dict(vocab_size=256, hidden_size=512, intermediate_size=1024,
               num_hidden_layers=2, num_attention_heads=2,
               num_key_value_heads=1, max_position_embeddings=64)


@pytest.fixture(scope="module")
def tiny256():
    paddle.seed(25)
    jmodel = JaxLlamaForCausalLM(JaxLlamaConfig(use_parallel=False,
                                                **TINY256))
    names, values = jmodel.functional_state()
    model = LlamaForCausalLM(LlamaConfig(**TINY256), device="cpu")
    assert model.config.head_dim == 256
    load_jax_state(model, names, [np.asarray(x) for x in values])
    return jmodel, model


def test_tiny_d256_llama_logits_loss_and_grads(tiny256):
    jmodel, model = tiny256
    v = TINY256["vocab_size"]
    rng = np.random.RandomState(5)
    ids = rng.randint(0, v, (2, 24)).astype(np.int32)
    labels = rng.randint(0, v, (2, 24)).astype(np.int32)
    with jax_no_grad():
        want_logits = np.asarray(jmodel(JaxTensor(ids))._value)
    with torch.no_grad():
        got_logits = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got_logits, want_logits,
                               atol=1e-4 * np.abs(want_logits).max(),
                               rtol=1e-4)
    names, values = jmodel.functional_state()

    def loss_of(vals):
        with jmodel.bind_state(names, vals):
            with jax_no_grad():
                loss = jF.cross_entropy(
                    jmodel(JaxTensor(ids)).reshape([-1, v]),
                    JaxTensor(labels).reshape([-1]))
        return loss._value

    want_loss, want_grads = jax.value_and_grad(loss_of)(list(values))
    loss = F.cross_entropy(model(torch.from_numpy(ids)).reshape(-1, v),
                           torch.from_numpy(labels).long().reshape(-1))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    params = dict(model.named_parameters())
    for name, want in zip(names, want_grads):
        want = np.asarray(want)
        np.testing.assert_allclose(params[name].grad.numpy(), want,
                                   rtol=1e-3, atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)
    model.zero_grad(set_to_none=True)


FLAG_NAMES = ("FLAGS_serving_prefix_cache", "FLAGS_serving_chunked_prefill",
              "FLAGS_serving_quant_kv")


@pytest.mark.parametrize("on", [False, True],
                         ids=["flags_off", "prefix-chunked-quant_kv"])
def test_tiny_d256_engines_agree(tiny256, on):
    jmodel, model = tiny256
    values = dict.fromkeys(FLAG_NAMES, on)
    rng = np.random.RandomState(6)
    base = rng.randint(0, TINY256["vocab_size"], (20,)).tolist()
    prompts = [base, base[:12] + [1, 2, 3], rng.randint(0, 256, (7,)).tolist()]
    tokens = []
    jax_flags.set_flags(values)
    flags.set_flags(values)
    try:
        for eng in (jax_serving.Engine(jmodel, max_slots=2, num_blocks=32,
                                       block_size=4, prefill_chunk=4),
                    Engine(model, device="cpu", max_slots=2, num_blocks=32,
                           block_size=4, prefill_chunk=4)):
            first = eng.add_request(prompts[0], max_new_tokens=5)
            eng.run()
            rest = [eng.add_request(p, max_new_tokens=5) for p in prompts[1:]]
            eng.run()
            tokens.append([eng.output(i) for i in [first] + rest])
            if on:
                assert eng.stats()["prefix_hit_tokens"] > 0
    finally:
        off = dict.fromkeys(FLAG_NAMES, False)
        jax_flags.set_flags(off)
        flags.set_flags(off)
    assert tokens[1] == tokens[0]


# -- the head dims the reference computes with XLA: D = 80 and 16 ----------

@pytest.mark.parametrize("d", [80, 16])
@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_takes_the_reference_path(d, causal):
    rng = np.random.RandomState(d + causal)
    q = rng.randn(2, 9, 4, d).astype(np.float32)
    k, v = (rng.randn(2, 9, 2, d).astype(np.float32) for _ in range(2))
    rep = lambda x: np.repeat(x, 2, axis=2)   # noqa: E731
    want = np.asarray(jF.scaled_dot_product_attention(
        JaxTensor(q), JaxTensor(rep(k)), JaxTensor(rep(v)),
        is_causal=causal)._value)
    before = fa.plain_head_dim_calls
    got = F.scaled_dot_product_attention(*_t(q, k, v), is_causal=causal)
    assert fa.plain_head_dim_calls == before + 1
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("d", [80, 16])
def test_paged_paths_take_the_reference_path(d):
    h, hkv = 4, 2
    lens, hist, q_lens, c = [0, 5, 19], [0, 3, 10], [4, 1, 2], 4
    rng, kv, bt = _pools(d, [max(a, b + n) for a, b, n in
                             zip(lens, hist, q_lens)], hkv, d, bs=8, mb=4)
    q = rng.randn(3, h, d).astype(np.float32)
    qm = rng.randn(3, c, h, d).astype(np.float32)
    sl, hl, ql = (np.asarray(x, np.int32) for x in (lens, hist, q_lens))
    jkv = {k: jnp.asarray(x) for k, x in kv.items()}
    tkv = dict(zip(kv, _t(*kv.values())))
    before = fa.plain_head_dim_calls
    got = pa.paged_attention(*_t(q), block_tables=torch.from_numpy(bt),
                             seq_lens=torch.from_numpy(sl), **tkv).numpy()
    want = np.asarray(jax_paged(
        jnp.asarray(q), block_tables=jnp.asarray(bt),
        seq_lens=jnp.asarray(sl), **jkv))
    np.testing.assert_allclose(got[sl > 0], want[sl > 0], **PAGED_TOL)
    got = pa.mixed_paged_attention(
        *_t(qm), block_tables=torch.from_numpy(bt),
        hist_lens=torch.from_numpy(hl), q_lens=torch.from_numpy(ql),
        **tkv).numpy()
    want = np.asarray(jax_mixed(
        jnp.asarray(qm), block_tables=jnp.asarray(bt),
        hist_lens=jnp.asarray(hl), q_lens=jnp.asarray(ql), **jkv))
    valid = np.arange(c)[None, :] < ql[:, None]
    np.testing.assert_allclose(got[valid], want[valid], **PAGED_TOL)
    assert fa.plain_head_dim_calls == before + 2


@pytest.mark.parametrize("d,route", [(16, "plain"), (64, "kernel"),
                                     (80, "plain"), (128, "kernel"),
                                     (256, "kernel"), (384, "raise")])
def test_head_dim_route(d, route):
    assert fa.head_dim_route(d) == route
    assert pa.HEAD_DIMS is fa.HEAD_DIMS == (64, 128, 256)


def test_no_kernel_head_dims_raise_on_cuda_naming_the_queue():
    """D = 384 is in 128Z, where the reference runs its kernel: the
    wrappers raise on (fake) CUDA tensors before any launch, naming
    ROADMAP A.3; so does varlen at D = 80 (the reference sends it to its
    kernel at any D)."""
    with FakeTensorMode(allow_non_fake_inputs=True):
        for d in (384, 80):
            x = torch.empty(1, 8, 2, d, device="cuda")
            with pytest.raises(ValueError, match="A.3"):
                fa.flash_attention(x, x, x, causal=True)
        x = torch.empty(1, 8, 2, 384, device="cuda")
        with pytest.raises(ValueError, match="A.3"):
            F.scaled_dot_product_attention(x, x, x, is_causal=True)
        with pytest.raises(ValueError, match="A.3"):
            F.variable_length_attention(
                *(torch.empty(1, 8, 2, 80, device="cuda"),) * 3,
                segment_ids=torch.zeros(1, 8, dtype=torch.int32,
                                        device="cuda"))
        pools = torch.empty(4, 16, 1, 384, device="cuda")
        with pytest.raises(ValueError, match="A.3"):
            pa.paged_attention(
                torch.empty(2, 2, 384, device="cuda"), pools, pools,
                torch.zeros(2, 3, dtype=torch.int32, device="cuda"),
                torch.ones(2, dtype=torch.int32, device="cuda"))


# -- sparse_attention and tie_word_embeddings --------------------------------

@pytest.mark.parametrize("mask", [None, "bool", "additive"])
def test_sparse_attention_matches_the_reference(mask):
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(2, 6, 2, 16).astype(np.float32) for _ in range(3))
    m = None
    if mask == "bool":
        m = rng.rand(6, 6) > 0.3
        m[:, 0] = True
    elif mask == "additive":
        m = rng.randn(1, 1, 6, 6).astype(np.float32)
    want = np.asarray(jF.sparse_attention(
        JaxTensor(q), JaxTensor(k), JaxTensor(v),
        attn_mask=None if m is None else jnp.asarray(m))._value)
    got = F.sparse_attention(*_t(q, k, v),
                             attn_mask=None if m is None else _t(m)[0])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_sparse_attention_csr_raises_where_the_reference_drops_it():
    rng = np.random.RandomState(4)
    q = rng.randn(1, 4, 1, 8).astype(np.float32)
    offset = np.array([[[0, 1, 2, 3, 4]]], np.int32)
    columns = np.array([[[0, 1, 2, 3]]], np.int32)
    # the reference: a diagonal pattern gives dense attention all the same
    dense = np.asarray(jF.sparse_attention(JaxTensor(q), JaxTensor(q),
                                           JaxTensor(q))._value)
    ignored = np.asarray(jF.sparse_attention(
        JaxTensor(q), JaxTensor(q), JaxTensor(q), jnp.asarray(offset),
        jnp.asarray(columns))._value)
    np.testing.assert_array_equal(ignored, dense)
    with pytest.raises(NotImplementedError, match="sparse_csr"):
        F.sparse_attention(*_t(q, q, q), *_t(offset, columns))


def test_tie_word_embeddings_raises_where_the_reference_ignores_it():
    cfg = dict(vocab_size=32, hidden_size=16, intermediate_size=32,
               num_hidden_layers=1, num_attention_heads=2,
               max_position_embeddings=16)
    paddle.seed(0)
    jmodel = JaxLlamaForCausalLM(JaxLlamaConfig(
        use_parallel=False, tie_word_embeddings=True, **cfg))
    # the reference keeps an lm_head weight of its own, [hidden, vocab],
    # apart from the [vocab, hidden] embedding
    names, values = jmodel.functional_state()
    shapes = dict(zip(names, (tuple(x.shape) for x in values)))
    assert shapes["lm_head.weight"] == (16, 32)
    assert shapes["llama.embed_tokens.weight"] == (32, 16)
    assert not np.array_equal(
        np.asarray(values[names.index("lm_head.weight")]),
        np.asarray(values[names.index("llama.embed_tokens.weight")]).T)
    with pytest.raises(NotImplementedError, match="tie_word_embeddings"):
        LlamaConfig(tie_word_embeddings=True, **cfg)
    assert LlamaConfig(tie_word_embeddings=False, **cfg) \
        .tie_word_embeddings is False


def test_scale_default_is_the_head_dims():
    """SDPA's plain path at D = 80 scales by 1 / sqrt(80), as the kernel
    wrapper would."""
    q = torch.randn(1, 3, 1, 80, generator=torch.Generator().manual_seed(0))
    got = F.scaled_dot_product_attention(q, q, q)
    want = F.scaled_dot_product_attention(q, q, q, scale=1 / math.sqrt(80))
    assert torch.equal(got, want)
