"""The port's ``nn.Transformer`` layers (``nn/layers/transformer.py``)
against the JAX package's, on the same weights.

Each reference layer is built, its weights redrawn from a numpy seed (the
reference deep-copies the first layer, so every layer would start equal)
and set on both sides: into the reference with ``set_value`` and into the
port through ``models.convert.load_jax_state`` under the reference's
names. d_model 16, 2 heads of 8, FFN 32, 2 + 2 layers, dropout 0 unless a
test says otherwise; the port runs on the CPU, where attention takes the
flash kernel's plain version (no mask) or SDPA's masked path (a mask).
Outputs, cached outputs and gradients agree to the other port tests'
float32 tolerance, rtol 1e-4 / atol 1e-5 (gradients: atol 1e-5 x
max|grad|, rtol 1e-3, as in ``test_torch_train.py``).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu_torch import nn
from paddle_tpu_torch.models import load_jax_state
from paddle_tpu_torch.nn import functional as F

TOL = dict(rtol=1e-4, atol=1e-5)
D, H, FFN = 16, 2, 32


def _np(x):
    return np.asarray(getattr(x, "_value", x))


def _redraw(jlayer, seed):
    """New random weights on the reference layer; returns ``(names,
    arrays)`` for the port."""
    rng = np.random.RandomState(seed)
    names, values = jlayer.functional_state()
    arrays = []
    params = dict(jlayer.named_parameters())
    for name, v in zip(names, values):
        a = (rng.randn(*np.shape(v)) * 0.3).astype(np.float32)
        if "norm" in name and name.endswith("weight"):
            a += 1.0
        params[name].set_value(a)
        arrays.append(a)
    return names, arrays


def _pair(jcls, tcls, seed, *args, **kw):
    paddle.seed(seed)
    jlayer = jcls(*args, **kw)
    layer = tcls(*args, device="cpu", **kw)
    names, arrays = _redraw(jlayer, seed)
    assert names == [n for n, _ in layer.named_parameters()]
    load_jax_state(layer, names, arrays)
    return jlayer, layer


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _causal(n):
    return np.where(np.tril(np.ones((n, n), bool)), 0.0, -1e9).astype(
        np.float32)


def _run(layer, *args):
    """Call the port layer on numpy arguments (None passes through)."""
    return layer(*[None if a is None else torch.from_numpy(a) for a in args])


# -- MultiHeadAttention -------------------------------------------------------

@pytest.mark.parametrize("kind", ["self", "cross", "mask", "kdim"])
def test_multi_head_attention_matches_reference(kind):
    kw = dict(kdim=12, vdim=10) if kind == "kdim" else {}
    jm, m = _pair(jnn.MultiHeadAttention, nn.MultiHeadAttention, 1, D, H,
                  **kw)
    q = _x(2, 2, 5, D)
    k = _x(3, 2, 7, kw.get("kdim", D)) if kind != "self" else q
    v = _x(4, 2, 7, kw.get("vdim", D)) if kind != "self" else q
    mask = None
    if kind == "mask":
        k = v = q
        mask = _x(5, 5, 5) > -0.5
        mask[:, 0] = True
    want = jm(paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v),
              None if mask is None else paddle.to_tensor(mask))
    got = _run(m, q, k, v, mask)
    np.testing.assert_allclose(got.detach().numpy(), _np(want), **TOL)


def test_attention_dropout_in_training_is_mirrored(monkeypatch):
    """Fault 5 of the reference, mirrored: in training the layer passes
    ``dropout_p=0.1`` to SDPA, which applies no attention dropout in
    either package."""
    jm, m = _pair(jnn.MultiHeadAttention, nn.MultiHeadAttention, 6, D, H,
                  dropout=0.1)
    seen = []
    sdpa = F.scaled_dot_product_attention

    def spy(*args, **kw):
        seen.append(kw.get("dropout_p"))
        return sdpa(*args, **kw)
    monkeypatch.setattr(F, "scaled_dot_product_attention", spy)
    x = _x(7, 2, 6, D)
    jm.train()
    m.train()
    got = _run(m, x)
    want = jm(paddle.to_tensor(x))
    m.eval()
    evaluated = _run(m, x)
    assert seen == [0.1, 0.0]
    np.testing.assert_allclose(got.detach().numpy(), _np(want), **TOL)
    np.testing.assert_array_equal(got.detach().numpy(),
                                  evaluated.detach().numpy())


@pytest.mark.parametrize("cache_kind", ["Cache", "StaticCache"])
def test_multi_head_attention_caches_match_reference(cache_kind):
    jm, m = _pair(jnn.MultiHeadAttention, nn.MultiHeadAttention, 8, D, H)
    mem = _x(9, 2, 5, D)
    steps = _x(10, 2, 3, D)
    if cache_kind == "StaticCache":
        jc = jm.gen_cache(paddle.to_tensor(mem), paddle.to_tensor(mem),
                          type=jnn.MultiHeadAttention.StaticCache)
        c = m.gen_cache(torch.from_numpy(mem), torch.from_numpy(mem),
                        type=nn.MultiHeadAttention.StaticCache)
        np.testing.assert_allclose(c.k.detach().numpy(), _np(jc.k), **TOL)
    else:
        jc = jm.gen_cache(paddle.to_tensor(mem))
        c = m.gen_cache(torch.from_numpy(mem))
        assert tuple(c.k.shape) == (2, 0, H, D // H)
    for t in range(steps.shape[1]):
        q = steps[:, t:t + 1]
        jout = jm(paddle.to_tensor(q), None, None, None, jc)
        out = m(torch.from_numpy(q), None, None, None, c)
        if cache_kind == "Cache":
            (jout, jc), (out, c) = jout, out
            assert c.k.shape[1] == t + 1
        np.testing.assert_allclose(out.detach().numpy(), _np(jout), **TOL)
    if cache_kind == "Cache":
        np.testing.assert_allclose(c.v.detach().numpy(), _np(jc.v), **TOL)


# -- encoder and decoder layers -----------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_layer_and_encoder_match_reference(normalize_before, masked):
    kw = dict(dropout=0.0, normalize_before=normalize_before)
    jl, tl = _pair(jnn.TransformerEncoderLayer, nn.TransformerEncoderLayer,
                   11, D, H, FFN, activation="gelu", **kw)
    src = _x(12, 2, 6, D)
    mask = _causal(6) if masked else None
    jmask = None if mask is None else paddle.to_tensor(mask)
    np.testing.assert_allclose(
        _run(tl, src, mask).detach().numpy(),
        _np(jl(paddle.to_tensor(src), jmask)), **TOL)
    paddle.seed(13)
    jenc = jnn.TransformerEncoder(jl, 2, jnn.LayerNorm(D))
    enc = nn.TransformerEncoder(tl, 2, nn.LayerNorm(D, device="cpu"))
    names, arrays = _redraw(jenc, 13)
    assert names == [n for n, _ in enc.named_parameters()]
    assert [p.name for p in enc.parameters()] == names
    load_jax_state(enc, names, arrays)
    np.testing.assert_allclose(
        _run(enc, src, mask).detach().numpy(),
        _np(jenc(paddle.to_tensor(src), jmask)), **TOL)


def test_encoder_incremental_cache_matches_reference():
    jl, tl = _pair(jnn.TransformerEncoderLayer, nn.TransformerEncoderLayer,
                   14, D, H, FFN, dropout=0.0)
    paddle.seed(15)
    jenc = jnn.TransformerEncoder(jl, 2)
    enc = nn.TransformerEncoder(tl, 2)
    load_jax_state(enc, *_redraw(jenc, 15))
    src = _x(16, 2, 3, D)
    jc = jenc.gen_cache(paddle.to_tensor(src))
    c = enc.gen_cache(torch.from_numpy(src))
    for t in range(3):
        x = src[:, t:t + 1]
        jout, jc = jenc(paddle.to_tensor(x), None, jc)
        out, c = enc(torch.from_numpy(x), None, c)
        np.testing.assert_allclose(out.detach().numpy(), _np(jout), **TOL)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_decoder_layer_and_decoder_match_reference(normalize_before):
    kw = dict(dropout=0.0, normalize_before=normalize_before)
    jl, tl = _pair(jnn.TransformerDecoderLayer, nn.TransformerDecoderLayer,
                   17, D, H, FFN, **kw)
    tgt, mem = _x(18, 2, 4, D), _x(19, 2, 6, D)
    mask = _causal(4)
    np.testing.assert_allclose(
        _run(tl, tgt, mem, mask).detach().numpy(),
        _np(jl(paddle.to_tensor(tgt), paddle.to_tensor(mem),
               paddle.to_tensor(mask))), **TOL)
    paddle.seed(20)
    jdec = jnn.TransformerDecoder(jl, 2, jnn.LayerNorm(D))
    dec = nn.TransformerDecoder(tl, 2, nn.LayerNorm(D, device="cpu"))
    load_jax_state(dec, *_redraw(jdec, 20))
    np.testing.assert_allclose(
        _run(dec, tgt, mem, mask).detach().numpy(),
        _np(jdec(paddle.to_tensor(tgt), paddle.to_tensor(mem),
                 paddle.to_tensor(mask))), **TOL)
    # incremental decoding: a Cache for self-attention and a StaticCache
    # of the memory for cross-attention, a layer each
    jc = jdec.gen_cache(paddle.to_tensor(mem))
    c = dec.gen_cache(torch.from_numpy(mem))
    assert isinstance(c[0][0], nn.MultiHeadAttention.Cache)
    assert isinstance(c[0][1], nn.MultiHeadAttention.StaticCache)
    for t in range(3):
        x = tgt[:, t:t + 1]
        jout, jc = jdec(paddle.to_tensor(x), paddle.to_tensor(mem), None,
                        None, jc)
        out, c = dec(torch.from_numpy(x), torch.from_numpy(mem), None, None,
                     c)
        np.testing.assert_allclose(out.detach().numpy(), _np(jout), **TOL)


# -- Transformer --------------------------------------------------------------

@pytest.mark.parametrize("normalize_before", [False, True])
def test_transformer_output_and_grads_match_reference(normalize_before):
    geometry = dict(d_model=D, nhead=H, num_encoder_layers=2,
                    num_decoder_layers=2, dim_feedforward=FFN, dropout=0.0,
                    normalize_before=normalize_before)
    jt, t = _pair(jnn.Transformer, nn.Transformer, 21, **geometry)
    src, tgt = _x(22, 2, 6, D), _x(23, 2, 5, D)
    mask = nn.Transformer.generate_square_subsequent_mask(5, device="cpu")
    np.testing.assert_array_equal(
        mask.numpy(), _np(jnn.Transformer.generate_square_subsequent_mask(5)))
    jout = jt(paddle.to_tensor(src), paddle.to_tensor(tgt), None,
              paddle.to_tensor(mask.numpy()))
    out = t(torch.from_numpy(src), torch.from_numpy(tgt), None, mask)
    np.testing.assert_allclose(out.detach().numpy(), _np(jout), **TOL)
    w = _x(24, *out.shape)
    (jout * paddle.to_tensor(w)).sum().backward()
    (out * torch.from_numpy(w)).sum().backward()
    jgrads = {n: _np(p.grad) for n, p in jt.named_parameters()}
    scale = max(float(np.abs(g).max()) for g in jgrads.values())
    for name, p in t.named_parameters():
        want = jgrads[name]
        if name.endswith("k_proj.bias"):
            # exactly 0: a key bias adds one constant to a query's scores,
            # which the softmax cancels; both sides hold rounding noise
            assert np.abs(p.grad.numpy()).max() < 1e-5 * scale, name
            assert np.abs(want).max() < 1e-5 * scale, name
            continue
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-3,
                                   atol=1e-5 * float(np.abs(want).max()),
                                   err_msg=name)


def test_transformer_layers_start_as_copies_with_one_dropout_stream():
    t = nn.Transformer(d_model=D, nhead=H, num_encoder_layers=3,
                       num_decoder_layers=2, dim_feedforward=FFN,
                       device="cpu")
    first, third = t.encoder.layers[0], t.encoder.layers[2]
    assert first is not third
    assert torch.equal(first.linear1.weight, third.linear1.weight)
    assert first.dropout1.generator is third.dropout1.generator
    assert third.linear1.weight.name == "encoder.layers.2.linear1.weight"
    # the reference's default geometry and names
    jt = jnn.Transformer(d_model=D, nhead=H, num_encoder_layers=3,
                         num_decoder_layers=2, dim_feedforward=FFN)
    assert ([n for n, _ in t.named_parameters()]
            == jt.functional_state()[0])
