"""The port's generation (``models/generation.py``) and SDPA's mask path
against the JAX package, on the same weights.

The reference Llama (``tiny``, 2 kv heads) is built from its own seed and
its ``functional_state()`` loads into the port through
``load_jax_state``; both run the same numpy prompts. Greedy and beam
tokens must be IDENTICAL to the reference's ``generate``; logits agree to
the float32 tolerance of the other port tests (rtol 1e-4 / atol 1e-5:
XLA's CPU transcendentals are approximate to ~1e-5 relative, and sums run
in other orders). Sampled tokens cannot equal the reference's (JAX's
random stream is not reproduced), so sampling is held to its filter, a
numpy transcription of the reference's, and to determinism per seed.
The port runs on the CPU (``device="cpu"``): its wrappers take their
plain versions.
"""
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig,
    LlamaForCausalLM as JaxLlamaForCausalLM,
)
from paddle_tpu.nn import functional as jax_F
from paddle_tpu_torch.models import (
    DecodeCache,
    LlamaConfig,
    LlamaForCausalLM,
    load_jax_state,
)
from paddle_tpu_torch.models.generation import decode_mask, sample_filter
from paddle_tpu_torch.nn import functional as F

TOL = dict(rtol=1e-4, atol=1e-5)
VOCAB = 256


@pytest.fixture(scope="module")
def pair():
    paddle.seed(3)
    jmodel = JaxLlamaForCausalLM(
        JaxLlamaConfig.tiny(use_parallel=False, num_key_value_heads=2))
    names, values = jmodel.functional_state()
    model = LlamaForCausalLM(LlamaConfig.tiny(num_key_value_heads=2),
                             device="cpu")
    load_jax_state(model, names, [np.asarray(v) for v in values])
    return jmodel, model


def _prompt(seed, b=2, n=5):
    return np.random.RandomState(seed).randint(0, VOCAB, (b, n)) \
        .astype(np.int32)


def _jax_generate(jmodel, prompt, **kw):
    return np.asarray(jmodel.generate(paddle.to_tensor(prompt),
                                      **kw)._value)


def _port_generate(model, prompt, **kw):
    out = model.generate(torch.from_numpy(prompt), **kw)
    assert out.dtype == torch.long and out.device == model.device
    return out.numpy()


# -- SDPA's mask path ---------------------------------------------------------

def _qkv(seed, b=2, n=6, m=9, h=4, h_kv=4, d=16):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, n, h, d).astype(np.float32),
            rng.randn(b, m, h_kv, d).astype(np.float32),
            rng.randn(b, m, h_kv, d).astype(np.float32))


def _sdpa_pair(q, k, v, mask, **kw):
    """(port, reference) outputs; the reference takes K/V repeated to q's
    heads, as the reference Llama hands them to it."""
    rep = q.shape[2] // k.shape[2]
    want = jax_F.scaled_dot_product_attention(
        q, np.repeat(k, rep, axis=2), np.repeat(v, rep, axis=2),
        attn_mask=mask, **kw)
    got = F.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        attn_mask=torch.from_numpy(np.asarray(mask)), **kw)
    return got.numpy(), np.asarray(getattr(want, "_value", want))


@pytest.mark.parametrize("kind", ["bool", "additive", "bool+causal",
                                  "bool gqa", "additive+causal gqa"])
def test_sdpa_mask_matches_reference(kind):
    h_kv = 2 if "gqa" in kind else 4
    q, k, v = _qkv(1, h_kv=h_kv)
    rng = np.random.RandomState(2)
    if kind.startswith("bool"):
        mask = rng.rand(q.shape[1], k.shape[1]) < 0.7
        mask[:, 0] = True
    else:
        mask = (rng.randn(q.shape[1], k.shape[1]) * 2).astype(np.float32)
    causal = "causal" in kind
    got, want = _sdpa_pair(q, k, v, mask, is_causal=causal)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("shape", ["s kv", "1 1 s kv", "B 1 s kv"])
def test_sdpa_mask_broadcasts(shape):
    q, k, v = _qkv(3)
    b, n, m = q.shape[0], q.shape[1], k.shape[1]
    dims = {"s kv": (n, m), "1 1 s kv": (1, 1, n, m),
            "B 1 s kv": (b, 1, n, m)}[shape]
    mask = np.random.RandomState(4).rand(*dims) < 0.6
    mask[..., 0] = True
    got, want = _sdpa_pair(q, k, v, mask)
    np.testing.assert_allclose(got, want, **TOL)


def test_sdpa_rect_causal_warns_and_dropout_raises():
    q, k, v = (torch.from_numpy(a) for a in _qkv(5))
    with pytest.warns(UserWarning, match="START-aligned"):
        F.scaled_dot_product_attention(q, k, v, is_causal=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                             _warn_rect_causal=False)
        # a mask silences it too, as in the reference
        F.scaled_dot_product_attention(
            q, k, v, attn_mask=torch.ones(6, 9, dtype=torch.bool),
            is_causal=True)
    want = jax_F.scaled_dot_product_attention(
        q.numpy(), k.numpy(), v.numpy(), is_causal=True,
        _warn_rect_causal=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(want._value), **TOL)
    # dropout_p is accepted and applies no dropout, as in the reference
    # (ROADMAP.md, "Faults of the reference" 5, mirrored)
    with_dropout = F.scaled_dot_product_attention(
        q, k, v, attn_mask=torch.ones(6, 9, dtype=torch.bool), is_causal=True,
        dropout_p=0.1)
    np.testing.assert_allclose(with_dropout.numpy(), out.numpy(), **TOL)


def test_decode_mask():
    assert decode_mask(0, 4, 9) == "causal"
    got = decode_mask(5, 2, 9).numpy()
    want = np.arange(9)[None, :] <= 5 + np.arange(2)[:, None]
    np.testing.assert_array_equal(got, want)
    # a tensor offset of 0 is not the static prefill: it takes the mask
    assert decode_mask(torch.tensor(0), 1, 3).tolist() == [[True, False,
                                                           False]]


# -- cached decode numerics ---------------------------------------------------

def test_cached_logits_match_full_forward(pair):
    """The reference's tests/test_generation.py oracle: a 4-token prefill
    then single-token steps, through the legacy growing ``(pk, pv)``
    caches and through ``DecodeCache`` buffers, equal the uncached JAX
    forward at each position."""
    jmodel, model = pair
    seq = _prompt(1, b=1, n=7)
    full = np.asarray(jmodel(paddle.to_tensor(seq))._value)
    cfg = model.config
    d = cfg.hidden_size // cfg.num_attention_heads
    legacy = [(torch.zeros(1, 0, cfg.num_key_value_heads, d),) * 2
              for _ in range(cfg.num_hidden_layers)]
    static = model.init_decode_caches(1, 7)
    assert all(isinstance(c, DecodeCache) for c in static)
    ids = torch.from_numpy(seq).long()
    with torch.no_grad():
        for caches in (legacy, static):
            pre = model.generate_step(ids[:, :4], caches, 0)
            np.testing.assert_allclose(pre.numpy(), full[:, :4], **TOL)
            for t in range(4, 7):
                logits = model.generate_step(ids[:, t:t + 1], caches, t)
                np.testing.assert_allclose(logits[:, 0].numpy(), full[:, t],
                                           err_msg="pos %d" % t, **TOL)
    # the legacy pairs grew in the caller's list; the buffers were written
    assert legacy[0][0].shape[1] == 7
    assert static[0].k[:, 6].abs().sum() > 0


# -- greedy and beam tokens against the reference -----------------------------

def test_greedy_matches_reference_with_eos_padding(pair):
    jmodel, model = pair
    prompt = _prompt(2)
    free = _port_generate(model, prompt, max_new_tokens=8)
    # the port's own oracle: argmax of a full forward each step
    seq = torch.from_numpy(prompt).long()
    with torch.no_grad():
        for t in range(8):
            nxt = model(seq)[:, -1].argmax(-1)
            np.testing.assert_array_equal(free[:, t], nxt.numpy())
            seq = torch.cat([seq, nxt[:, None]], dim=1)
    # row 0's third token as eos: row 0 pads after it, row 1 runs on
    eos = int(free[0, 2])
    got = _port_generate(model, prompt, max_new_tokens=8, eos_token_id=eos)
    want = _jax_generate(jmodel, prompt, max_new_tokens=8, eos_token_id=eos)
    np.testing.assert_array_equal(got, want)
    first = list(got[0]).index(eos)
    assert (got[0, first:] == eos).all() and first <= 2


def test_all_rows_at_eos_stop_early(pair):
    _, model = pair
    prompt = _prompt(2)
    calls = []
    step = model.generate_step

    def counted(*args):
        calls.append(1)
        return step(*args)

    first = _port_generate(model, prompt, max_new_tokens=1)
    model.generate_step = counted
    try:
        out = _port_generate(model, prompt[:1], max_new_tokens=6,
                             eos_token_id=int(first[0, 0]))
    finally:
        del model.generate_step
    np.testing.assert_array_equal(out, np.full((1, 6), first[0, 0]))
    assert len(calls) == 1      # the prefill, then every row was done


@pytest.mark.parametrize("eos,lp", [(False, 0.0), (True, 1.0), (True, 2.0)])
def test_beam_search_matches_reference(pair, eos, lp):
    """Without eos; with an eos the beams reach (the greedy continuation's
    second token), where at alpha = 1 the finished beam wins and stays
    frozen on eos, and at alpha = 2 the length penalty picks a longer
    one."""
    jmodel, model = pair
    prompt = _prompt(3)
    kw = dict(max_new_tokens=6, num_beams=3, length_penalty=lp)
    if eos:
        kw["eos_token_id"] = int(
            _port_generate(model, prompt, max_new_tokens=2)[0, 1])
    got = _port_generate(model, prompt, **kw)
    want = _jax_generate(jmodel, prompt, **kw)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 6)
    if eos:
        frozen = (got[0, 1:] == kw["eos_token_id"]).all()
        assert frozen == (lp == 1.0), got


def test_beam_rejects_sampling(pair):
    _, model = pair
    with pytest.raises(ValueError, match="beam search is deterministic"):
        model.generate(torch.zeros(1, 2, dtype=torch.long), num_beams=2,
                       do_sample=True)


# -- sampling -----------------------------------------------------------------

def _np_filter(logits, top_k, top_p):
    """The reference's filter (paddle_tpu/models/generation.py:188-203)
    transcribed to numpy."""
    if top_k:
        kth = np.sort(logits, axis=-1)[:, -top_k][:, None]
        logits = np.where(logits < kth, -np.inf, logits)
    if top_p < 1.0:
        sorted_l = np.sort(logits, axis=-1)[:, ::-1]
        e = np.exp(sorted_l - sorted_l[:, :1])
        cum = np.cumsum(e / e.sum(-1, keepdims=True), axis=-1)
        cutoff_idx = np.sum(cum < top_p, axis=-1)
        cutoff = np.take_along_axis(sorted_l, cutoff_idx[:, None], axis=-1)
        logits = np.where(logits < cutoff, -np.inf, logits)
    return logits


@pytest.mark.parametrize("top_k,top_p", [(3, 1.0), (0, 0.5), (4, 0.8),
                                         (1, 0.3), (0, 0.999)])
def test_sample_filter_matches_reference_formula(top_k, top_p):
    rng = np.random.RandomState(6)
    logits = rng.randn(4, 12).astype(np.float32) * 2
    # ties: at the k-th value (row 1) and across the top-p cutoff (row 2)
    logits[1, :5] = 1.5
    logits[2] = np.repeat(np.float32([3.0, 2.0, 1.0, 0.0]), 3)
    got = sample_filter(torch.from_numpy(logits), top_k, top_p).numpy()
    want = _np_filter(logits.astype(np.float64), top_k, top_p)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got[~np.isinf(got)],
                                  logits[~np.isinf(want)])
    if top_k == 3:
        # row 1's five tied leaders all stay at k = 3
        assert np.isfinite(got[1, :5]).all()


def test_sampling_is_deterministic_per_seed(pair):
    _, model = pair
    prompt = _prompt(4, b=3)
    kw = dict(max_new_tokens=6, do_sample=True, top_k=8, top_p=0.9,
              temperature=0.8)
    a = _port_generate(model, prompt, seed=11, **kw)
    b = _port_generate(model, prompt, seed=11, **kw)
    c = _port_generate(model, prompt, seed=12, **kw)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert ((a >= 0) & (a < VOCAB)).all()
    # one candidate left: sampling is greedy
    np.testing.assert_array_equal(
        _port_generate(model, prompt, max_new_tokens=6, do_sample=True,
                       top_k=1, seed=5),
        _port_generate(model, prompt, max_new_tokens=6))


# -- the mixin's contract -----------------------------------------------------

def test_over_length_raises_and_training_flag_is_restored(pair):
    _, model = pair
    limit = model.max_decode_len()
    with pytest.raises(ValueError, match="exceeds the model's maximum"):
        model.generate(torch.zeros(1, limit - 3, dtype=torch.long),
                       max_new_tokens=4)
    model.train()
    try:
        out = model.generate(torch.zeros(1, limit - 4, dtype=torch.long),
                             max_new_tokens=4)
        assert out.shape == (1, 4) and model.training
    finally:
        model.eval()
    assert not out.requires_grad


def test_import_sums_bf16_products_in_fp32():
    code = ("import torch\n"
            "m = torch.backends.cuda.matmul\n"
            "assert m.allow_bf16_reduced_precision_reduction\n"
            "import paddle_tpu_torch\n"
            "assert not m.allow_bf16_reduced_precision_reduction\n"
            "assert not m.allow_tf32\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
