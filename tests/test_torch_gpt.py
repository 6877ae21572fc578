"""The port's GPT (``models/gpt.py``) and the ``nn`` pieces it needs
against the JAX package, on the same weights.

The reference GPT (vocab 64, hidden 32, 2 layers, 4 heads) is built from
its own seed, its token embedding scaled to std 0.1 (nearer GPT-2's own
0.02 than the N(0, 1) default, under which the tied logits make greedy
decoding repeat the last token), and its ``functional_state()`` loads
into the port through ``load_jax_state`` under the same names. Logits
and losses agree to the float32 tolerance of the other port tests (rtol
1e-4 / atol 1e-5); greedy and beam tokens equal the reference's
``generate``; the port's serving engine on GPT gives the port's
``generate`` tokens, as the reference's tests/test_serving.py holds its
own engine. The port runs on the CPU
(``device="cpu"``): its wrappers take their plain versions.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTModel as JaxGPTModel
from paddle_tpu.nn import functional as jax_F
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.kernels.quant import (int8_weight_matmul_reference,
                                            int8_weight_routes,
                                            quantize_int8_weight)
from paddle_tpu_torch.models import GPTModel, load_jax_state
from paddle_tpu_torch.models.gpt import GPTBlock
from paddle_tpu_torch.nn import Dropout, LayerNorm, Linear
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.serving import Engine

TOL = dict(rtol=1e-4, atol=1e-5)
VOCAB = 64
GEOMETRY = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=4,
                max_seq_len=64)


@pytest.fixture(scope="module")
def pair():
    paddle.seed(5)
    jmodel = JaxGPTModel(**GEOMETRY)
    jmodel.wte.weight.set_value(np.asarray(jmodel.wte.weight._value) * 0.1)
    names, values = jmodel.functional_state()
    model = GPTModel(**GEOMETRY, device="cpu")
    load_jax_state(model, names, [np.asarray(v) for v in values])
    model.eval()
    return jmodel, model


def _np(x):
    return np.asarray(getattr(x, "_value", x))


def _prompt(seed, b=2, n=6):
    return np.random.RandomState(seed).randint(0, VOCAB, (b, n)) \
        .astype(np.int32)


# -- nn pieces ----------------------------------------------------------------

@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_matches_reference(approximate):
    x = np.random.RandomState(0).randn(5, 7).astype(np.float32) * 3
    got = F.gelu(torch.from_numpy(x), approximate=approximate).numpy()
    np.testing.assert_allclose(
        got, _np(jax_F.gelu(x, approximate=approximate)), **TOL)
    if not approximate:
        # the default is the erf form
        np.testing.assert_array_equal(
            got, F.gelu(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("shape", [8, (3, 8)])
def test_layer_norm_matches_reference(shape):
    rng = np.random.RandomState(1)
    x = (rng.randn(2, 3, 8) * 4 + 1).astype(np.float32)
    nshape = (shape,) if isinstance(shape, int) else shape
    w = rng.randn(*nshape).astype(np.float32)
    b = rng.randn(*nshape).astype(np.float32)
    got = F.layer_norm(torch.from_numpy(x), shape, torch.from_numpy(w),
                       torch.from_numpy(b), epsilon=1e-5).numpy()
    np.testing.assert_allclose(
        got, _np(jax_F.layer_norm(x, shape, w, b, epsilon=1e-5)), **TOL)
    layer = LayerNorm(shape, device="cpu")
    assert [n for n, _ in layer.named_parameters()] == ["weight", "bias"]
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w))
        layer.bias.copy_(torch.from_numpy(b))
        np.testing.assert_allclose(layer(torch.from_numpy(x)).numpy(), got,
                                   **TOL)
    bare = LayerNorm(shape, weight_attr=False, bias_attr=False, device="cpu")
    assert not list(bare.parameters())
    np.testing.assert_allclose(bare(torch.from_numpy(x)).numpy(),
                               _np(jax_F.layer_norm(x, shape)), **TOL)


@pytest.mark.parametrize("bias", [True, False])
def test_linear_bias_rule_and_int8_route(bias):
    gen = torch.Generator().manual_seed(0)
    lin = Linear(24, 40, bias_attr=None if bias else False, generator=gen,
                 device="cpu")
    names = [n for n, _ in lin.named_parameters()]
    assert names == (["weight", "bias"] if bias else ["weight"])
    x = np.random.RandomState(2).randn(3, 5, 24).astype(np.float32)
    b = None
    if bias:
        assert not lin.bias.any()          # zero-initialised
        b = np.random.RandomState(3).randn(40).astype(np.float32)
        with torch.no_grad():
            lin.bias.copy_(torch.from_numpy(b))
    w = lin.weight.detach().numpy()
    with torch.no_grad():
        got = lin(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, _np(jax_F.linear(x, w, b)), **TOL)
        # the int8 route adds the bias after the int8-weight product
        q, scales = quantize_int8_weight(lin.weight)
        with int8_weight_routes({lin: (q, scales)}):
            routed = lin(torch.from_numpy(x))
        want = int8_weight_matmul_reference(
            torch.from_numpy(x).reshape(15, 24), q, scales).reshape(3, 5, 40)
        if bias:
            want = want + lin.bias
    np.testing.assert_allclose(routed.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_dropout_modes():
    x = torch.from_numpy(
        np.random.RandomState(4).rand(200, 100).astype(np.float32) + 1)
    drop = Dropout(0.25)
    drop.eval()
    assert drop(x) is x
    assert F.dropout(x, p=0.0, training=True) is x
    np.testing.assert_allclose(
        F.dropout(x, 0.25, training=False, mode="downscale_in_infer"),
        _np(jax_F.dropout(x.numpy(), 0.25, training=False,
                          mode="downscale_in_infer")), **TOL)
    # training: kept with probability 1 - p, scaled by 1 / (1 - p)
    gen = torch.Generator().manual_seed(7)
    drop = Dropout(0.25, generator=gen)
    drop.train()
    y = drop(x)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.01
    torch.testing.assert_close(y[kept], x[kept] / 0.75)
    assert (y != drop(x)).any()            # the generator advanced
    down = F.dropout(x, 0.25, training=True, mode="downscale_in_infer",
                     seed=3)
    torch.testing.assert_close(down[down != 0], x[down != 0])
    torch.testing.assert_close(
        F.dropout(x, 0.25, seed=3), F.dropout(x, 0.25, seed=3))


# -- GPT ----------------------------------------------------------------------

def test_parameter_names_match_reference(pair):
    jmodel, model = pair
    names, _ = jmodel.functional_state()
    assert sorted(names) == sorted(n for n, _ in model.named_parameters())
    assert model.max_decode_len() == 64
    spec = model.paged_cache_spec()
    assert (spec["num_layers"], spec["num_kv_heads"], spec["head_dim"],
            spec["dtype"]) == (2, 4, 8, torch.float32)


def test_logits_and_loss_match_reference(pair):
    jmodel, model = pair
    ids = _prompt(0, b=3, n=10)
    labels = np.random.RandomState(1).randint(0, VOCAB, ids.shape)
    labels[0, :3] = -100
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long())
        loss = model(torch.from_numpy(ids).long(),
                     labels=torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(),
                               _np(jmodel(paddle.to_tensor(ids))), **TOL)
    want = jmodel(paddle.to_tensor(ids),
                  labels=paddle.to_tensor(labels.astype(np.int32)))
    np.testing.assert_allclose(float(loss), float(_np(want)), **TOL)


def test_cached_logits_match_full_forward(pair):
    """A 5-token prefill into ``DecodeCache`` buffers, then single-token
    steps, equal the uncached reference forward at each position."""
    jmodel, model = pair
    seq = _prompt(2, b=2, n=8)
    full = _np(jmodel(paddle.to_tensor(seq)))
    caches = model.init_decode_caches(2, 8)
    ids = torch.from_numpy(seq).long()
    with torch.no_grad():
        pre = model.generate_step(ids[:, :5], caches, 0)
        np.testing.assert_allclose(pre.numpy(), full[:, :5], **TOL)
        for t in range(5, 8):
            logits = model.generate_step(ids[:, t:t + 1], caches, t)
            np.testing.assert_allclose(logits[:, 0].numpy(), full[:, t],
                                       err_msg="pos %d" % t, **TOL)


def test_greedy_matches_reference_with_eos_padding(pair):
    jmodel, model = pair
    prompt = _prompt(3, b=3, n=5)
    free = model.generate(torch.from_numpy(prompt), max_new_tokens=6)
    eos = int(free[1, 1])
    got = model.generate(torch.from_numpy(prompt), max_new_tokens=6,
                         eos_token_id=eos).numpy()
    want = _np(jmodel.generate(paddle.to_tensor(prompt), max_new_tokens=6,
                               eos_token_id=eos))
    np.testing.assert_array_equal(got, want)
    assert (got[1, 1:] == eos).all()


def test_beam_search_matches_reference(pair):
    jmodel, model = pair
    prompt = _prompt(4, b=2, n=4)
    kw = dict(max_new_tokens=5, num_beams=4, length_penalty=1.0,
              eos_token_id=int(model.generate(torch.from_numpy(prompt),
                                              max_new_tokens=1)[0, 0]))
    got = model.generate(torch.from_numpy(prompt), **kw).numpy()
    want = _np(jmodel.generate(paddle.to_tensor(prompt), **kw))
    np.testing.assert_array_equal(got, want)


SERVE_FLAGS = ("FLAGS_serving_prefix_cache", "FLAGS_serving_chunked_prefill")


@pytest.mark.parametrize("tier2", [False, True])
def test_engine_matches_generate(pair, tier2):
    """The reference's engine oracle (tests/test_serving.py: slot reuse
    over 2 slots, 3 prompts of 4, 7 and 10 tokens): each request's tokens
    equal ``generate``'s; with the prefix cache and chunked prefill the
    learned positions come from per-row ``[B]`` offsets."""
    _, model = pair
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, VOCAB, (n,)).tolist() for n in (4, 7, 10)]
    flags.set_flags(dict.fromkeys(SERVE_FLAGS, tier2))
    try:
        eng = Engine(model, max_slots=2, num_blocks=32, block_size=4,
                     prefill_chunk=4, device="cpu")
    finally:
        flags.set_flags(dict.fromkeys(SERVE_FLAGS, False))
    ids = [eng.add_request(p, max_new_tokens=5) for p in prompts]
    outs = eng.run()
    for p, rid in zip(prompts, ids):
        want = model.generate(torch.tensor([p]), max_new_tokens=5)
        assert outs[rid] == want[0].tolist()
    if tier2:
        assert eng.stats()["mixed_steps"] > 0


def test_unported_options_and_tuple_cache_raise(pair):
    _, model = pair
    with pytest.raises(TypeError, match="DecodeCache"):
        model.generate_step(torch.zeros(1, 2, dtype=torch.long),
                            [(torch.zeros(1, 0, 4, 8),) * 2] * 2, 0)
    with pytest.raises(ValueError, match="exceeds the model's maximum"):
        model.generate(torch.zeros(1, 60, dtype=torch.long),
                       max_new_tokens=5)
    for kw in (dict(use_parallel=True), dict(moe_experts=4)):
        with pytest.raises(NotImplementedError, match="A.7"):
            GPTModel(**GEOMETRY, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="A.7"):
        GPTBlock(32, 4, 128, moe_experts=2, generator=None, device="cpu")
