"""The port's ERNIE (``models/ernie.py``) against the JAX package's, on the
same weights.

The reference model (``ErnieConfig.tiny()``: vocab 128, hidden 32, 2
layers of 4 heads, FFN 64, 64 positions, 2 token types, dropout 0) is
built from its own seed and its ``functional_state()`` loads into the
port through ``models.convert.load_jax_state`` under the same names. The
port runs on the CPU (``device="cpu"``): attention takes the flash
kernel's plain version without a mask and SDPA's masked path with one,
the fused MLM tail the fused CE kernels' plain versions.

Hidden states, pooled outputs, logits and losses agree to the other port
tests' float32 tolerance, rtol 1e-4 / atol 1e-5. The fused MLM loss is
held against the reference's loss (the reference's fused tail runs only
under its compiled step; in eager mode it computes the same mean
cross-entropy unfused) and the fused gradients against the unfused ones
(atol 1e-5 x max|grad|, rtol 1e-3, as ``test_torch_train.py``). After
two AdamW steps that decay only the parameters PaddleNLP's idiom picks,
every parameter agrees to rtol 1e-4 / atol 1e-5, but for the key bias:
its gradient is 0 in exact arithmetic (a key bias adds one constant to a
query's scores, which the softmax cancels), so each side holds rounding
noise there; Adam turns that noise into steps of up to ~lr, and those
entries are held only to that bound (and their gradients to 1e-5 of the
largest gradient).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.ernie import (
    ErnieConfig as JaxErnieConfig,
    ErnieForPretraining as JaxErnieForPretraining,
    ErnieForSequenceClassification as JaxErnieForSequenceClassification,
)
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.models import (ErnieConfig, ErnieForPretraining,
                                     ErnieForSequenceClassification,
                                     load_jax_state)
from paddle_tpu_torch.optimizer import AdamW

TOL = dict(rtol=1e-4, atol=1e-5)
VOCAB = 128
NO_DECAY = ("bias", "norm", "ln")


def _np(x):
    return np.asarray(getattr(x, "_value", x))


def _pair(jcls, cls, seed, fuse_qkv=False, **kw):
    paddle.seed(seed)
    jmodel = jcls(JaxErnieConfig.tiny(fuse_qkv=fuse_qkv), **kw)
    names, values = jmodel.functional_state()
    model = cls(ErnieConfig.tiny(fuse_qkv=fuse_qkv), device="cpu", **kw)
    load_jax_state(model, names, [np.asarray(v) for v in values])
    return jmodel, model


@pytest.fixture(scope="module", params=[False, True], ids=["qkv", "fused"])
def pretraining(request):
    return _pair(JaxErnieForPretraining, ErnieForPretraining, 3,
                 fuse_qkv=request.param)


def _batch(seed, b=2, s=12):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, VOCAB, (b, s)).astype(np.int64)
    types = (np.arange(s) >= s // 2).astype(np.int64)[None].repeat(b, 0)
    masked = np.where(rng.rand(b, s) < 0.15, ids, -100)
    masked[:, 1] = ids[:, 1]          # at least one masked token a row
    sop = rng.randint(0, 2, (b,)).astype(np.int64)
    return ids, types, masked, sop


def _key_bias(name, value):
    """The key-bias entries of a parameter (see the module docstring):
    all of ``k_proj.bias``, the middle third of ``qkv_proj.bias``."""
    keep = np.zeros(value.shape, bool)
    if name.endswith("k_proj.bias"):
        keep[:] = True
    elif name.endswith("qkv_proj.bias"):
        h = value.shape[0] // 3
        keep[h:2 * h] = True
    return keep


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [None if a is None else paddle.to_tensor(a) for a in arrays]


@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("types", [False, True])
def test_ernie_model_matches_reference(pretraining, types, mask):
    jmodel, model = pretraining
    ids, tt, _, _ = _batch(1)
    tt = tt if types else None
    attn = None
    if mask:
        # padding: the last 3 keys of row 1 masked, broadcast [B, 1, 1, S]
        keep = np.ones((2, 1, 1, ids.shape[1]), bool)
        keep[1, ..., -3:] = False
        attn = keep
    h, pooled = model.ernie(*_t(ids, tt, attn))
    jh, jpooled = jmodel.ernie(*_j(ids, tt, attn))
    np.testing.assert_allclose(h.detach().numpy(), _np(jh), **TOL)
    np.testing.assert_allclose(pooled.detach().numpy(), _np(jpooled), **TOL)


def test_pretraining_logits_match_reference(pretraining):
    jmodel, model = pretraining
    ids, tt, _, _ = _batch(2)
    mlm, sop = model(*_t(ids, tt))
    jmlm, jsop = jmodel(*_j(ids, tt))
    np.testing.assert_allclose(mlm.detach().numpy(), _np(jmlm), **TOL)
    np.testing.assert_allclose(sop.detach().numpy(), _np(jsop), **TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_pretraining_loss_unfused_and_fused(pretraining, fused):
    """B x S = 256 tokens: the fused gate applies with the flag on."""
    jmodel, model = pretraining
    ids, tt, masked, sop = _batch(4, b=4, s=64)
    want = _np(jmodel(*_j(ids, tt, masked, sop)))
    flags.set_flags({"FLAGS_fused_lm_head_ce": fused})
    try:
        model.zero_grad()
        loss = model(*_t(ids, tt, masked, sop))
        loss.backward()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    finally:
        flags.set_flags({"FLAGS_fused_lm_head_ce": False})
    np.testing.assert_allclose(loss.item(), want, **TOL)
    if fused:
        # the bias folded into the kernels' pad block reaches mlm_head.bias
        model.zero_grad()
        model(*_t(ids, tt, masked, sop)).backward()
        scale = max(float(p.grad.abs().max()) for p in model.parameters())
        for name, p in model.named_parameters():
            ref, got = p.grad.numpy(), grads[name].numpy()
            kb = _key_bias(name, ref)
            assert np.abs(got[kb]).max(initial=0) < 1e-5 * scale, name
            np.testing.assert_allclose(
                got[~kb], ref[~kb], rtol=1e-3,
                atol=1e-5 * float(np.abs(ref).max()), err_msg=name)
        assert grads["mlm_head.bias"].abs().max() > 0


def test_fused_mlm_tail_launches_the_fused_function(monkeypatch):
    """With the flag on, the loss goes through ``fused_mean_ce`` on
    ``h`` padded to hidden + 128 columns; off, or at a token count that
    does not tile 256, it does not."""
    from paddle_tpu_torch.models import ernie
    _, model = _pair(JaxErnieForPretraining, ErnieForPretraining, 5)
    calls = []
    real = ernie.fused_mean_ce

    def spy(h, w, labels):
        calls.append((tuple(h.shape), tuple(w.shape)))
        return real(h, w, labels)
    monkeypatch.setattr(ernie, "fused_mean_ce", spy)
    ids, tt, masked, sop = _batch(6, b=4, s=64)
    flags.set_flags({"FLAGS_fused_lm_head_ce": True})
    try:
        model(*_t(ids, tt, masked, sop))
        model(*_t(*(a[:, :12] for a in (ids, tt, masked)), sop))
    finally:
        flags.set_flags({"FLAGS_fused_lm_head_ce": False})
    model(*_t(ids, tt, masked, sop))
    assert calls == [((256, 32 + 128), (32 + 128, VOCAB))]


@pytest.mark.parametrize("labels", [False, True])
def test_sequence_classification_matches_reference(labels):
    jmodel, model = _pair(JaxErnieForSequenceClassification,
                          ErnieForSequenceClassification, 7, num_classes=3)
    ids, tt, _, _ = _batch(8, b=3)
    y = np.array([0, 2, 1], np.int64) if labels else None
    got = model(*_t(ids, tt, y))
    want = jmodel(*_j(ids, tt, y))
    np.testing.assert_allclose(got.detach().numpy(), _np(want), **TOL)


def test_two_adamw_steps_with_apply_decay_param_fun():
    """PaddleNLP's idiom, unchanged, in both packages: decay the
    parameters whose path names no bias or norm."""
    jmodel, model = _pair(JaxErnieForPretraining, ErnieForPretraining, 9,
                          fuse_qkv=True)
    opts = []
    for m, cls in ((jmodel, JaxAdamW), (model, AdamW)):
        decay = [p.name for n, p in m.named_parameters()
                 if not any(s in n for s in NO_DECAY)]
        opts.append(cls(learning_rate=0.01, weight_decay=0.1,
                        parameters=m.parameters(),
                        apply_decay_param_fun=lambda x, d=decay: x in d))
    jopt, opt = opts
    decayed = [n for n, p in model.named_parameters()
               if opt._decay_for(p)]
    assert "mlm_head.weight" in decayed and "mlm_head.bias" not in decayed
    assert not any("ln" in n for n in decayed)
    for step in range(2):
        ids, tt, masked, sop = _batch(10 + step)
        jloss = jmodel(*_j(ids, tt, masked, sop))
        jloss.backward()
        jopt.step()
        jopt.clear_grad()
        loss = model(*_t(ids, tt, masked, sop))
        loss.backward()
        opt.step()
        opt.clear_grad()
        np.testing.assert_allclose(loss.item(), _np(jloss), **TOL)
    jparams = dict(jmodel.named_parameters())
    for name, p in model.named_parameters():
        got, want = p.detach().numpy(), _np(jparams[name])
        kb = _key_bias(name, want)
        np.testing.assert_allclose(got[~kb], want[~kb], **TOL, err_msg=name)
        # two steps of at most ~lr each, on either side
        assert np.abs(got[kb] - want[kb]).max(initial=0) <= 4 * 0.01, name


def test_names_config_and_device():
    model = ErnieForSequenceClassification(ErnieConfig.tiny(), device="cpu")
    assert all(p.name == n for n, p in model.named_parameters())
    base = ErnieConfig.base(fuse_qkv=True)
    assert (base.vocab_size, base.hidden_size, base.num_hidden_layers,
            base.num_attention_heads, base.intermediate_size,
            base.max_position_embeddings, base.type_vocab_size) == (
        40000, 768, 12, 12, 3072, 512, 4)
    with pytest.raises(NotImplementedError, match="use_parallel"):
        ErnieConfig.tiny(use_parallel=True)
