"""The port's fused lm_head + cross-entropy against the JAX package's.

Inputs are numpy arrays from a seed, given to both packages. The JAX side
runs its Pallas kernels in interpret mode (``fused_lm_head_ce(...,
interpret=True)`` and ``jax.grad`` through its ``custom_vjp``, as
``tests/test_kernels.py::TestFusedCE`` does); the port runs on the CPU,
where the wrappers take their plain versions. The CUDA kernels run only on
the card: ``chip_smoke.py`` holds them against these plain versions.

Tolerances. float32: losses rtol/atol 1e-5, gradients of the
mean-over-valid rtol 1e-4, atol 1e-7 (the reference test's own: sums of
exps taken tile by tile vs over whole rows, and XLA's CPU transcendentals
are approximate to ~1e-5 relative). bfloat16: the logits are float32 sums
of exact bf16 products on both sides and agree as in float32, but dl is
rounded to bf16 at the same point on both sides, and a p that differs by
one float32 ulp can round to the neighbouring bf16 (2^-8 relative) in a
few elements; dh and dW are then rounded to bf16 themselves. So bf16
gradients are held to atol 1e-2 x max|grad| and rtol 1e-2 (one to two
bf16 ulps), losses to rtol/atol 1e-5. Llama: the trajectory tolerance of
``test_torch_train.py`` (rtol 1e-4 over 5 AdamW steps), first-step
gradients atol 1e-5 x max|grad|, rtol 1e-3, and fused against unfused on
the port within the reference's own rtol 2e-4 (``test_kernels.py:368``).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as paddle
from paddle_tpu.core import flags as jax_flags
from paddle_tpu.core.dispatch import no_grad as jax_no_grad
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.kernels.fused_ce import fused_lm_head_ce as jax_fused_ce
from paddle_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig,
    LlamaForCausalLM as JaxLlamaForCausalLM,
)
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.parallel.engine import CompiledTrainStep
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.kernels import fused_ce as fc
from paddle_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    load_jax_state,
)
from paddle_tpu_torch.models import llama as port_llama
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel import TrainStep

FLAG = "FLAGS_fused_lm_head_ce"
T, H = 512, 64
BF16_GRAD = dict(rtol=1e-2, scale=1e-2)


@pytest.fixture
def fused_flag():
    """Both packages' flag on for the test, off again after it."""
    flags.set_flags({FLAG: True})
    jax_flags.set_flags({FLAG: True})
    try:
        yield
    finally:
        flags.set_flags({FLAG: False})
        jax_flags.set_flags({FLAG: False})


def _case(vocab, seed=0):
    rng = np.random.RandomState(seed)
    h = (rng.randn(T, H) * 0.5).astype(np.float32)
    w = (rng.randn(H, vocab) * 0.1).astype(np.float32)
    labels = rng.randint(0, vocab, (T,)).astype(np.int32)
    labels[::7] = -100
    return h, w, labels


def _jax_mean_valid(labels):
    valid = (labels != -100).astype(jnp.float32)
    return lambda losses: jnp.sum(losses) / jnp.maximum(jnp.sum(valid), 1.0)


def _close(got, want, rtol, atol=0.0, scale=None):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    if scale is not None:
        atol = scale * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


# -- the loss and its gradients against the Pallas kernel ---------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vocab", [2048, 2000])   # tileable + ragged
def test_fused_ce_matches_the_pallas_kernel(vocab, dtype):
    h, w, labels = _case(vocab)
    jh, jw = jnp.asarray(h, dtype), jnp.asarray(w, dtype)
    jl = jnp.asarray(labels)
    want = jax_fused_ce(jh, jw, jl, -100, 256, 1024, True)
    mean_valid = _jax_mean_valid(jl)
    want_dh, want_dw = jax.grad(lambda a, b: mean_valid(jax_fused_ce(
        a, b, jl, -100, 256, 1024, True)), argnums=(0, 1))(jh, jw)

    tdtype = getattr(torch, dtype)
    th = torch.from_numpy(h).to(tdtype).requires_grad_()
    tw = torch.from_numpy(w).to(tdtype).requires_grad_()
    tl = torch.from_numpy(labels)
    losses = fc.fused_lm_head_ce(th, tw, tl)
    assert losses.dtype == torch.float32 and losses.shape == (T,)
    assert not losses[::7].any()
    _close(losses, want, rtol=1e-5, atol=1e-5)
    fc.fused_mean_ce(th, tw, tl).backward()
    assert th.grad.dtype == tdtype and tw.grad.shape == (H, vocab)
    if dtype == "float32":
        _close(th.grad, want_dh, rtol=1e-4, atol=1e-7)
        _close(tw.grad, want_dw, rtol=1e-4, atol=1e-7)
    else:
        _close(th.grad, want_dh, **BF16_GRAD)
        _close(tw.grad, want_dw, **BF16_GRAD)


@pytest.mark.parametrize("vocab", [2048, 2000])
def test_plain_forward_and_backward_match_the_pallas_kernels(vocab):
    """The wrappers' plain versions on their own (safe labels, an explicit
    upstream gradient), against the reference's ``_pallas_fwd`` and
    ``_pallas_bwd`` in interpret mode."""
    from paddle_tpu.kernels.fused_ce import _pallas_bwd, _pallas_fwd

    h, w, labels = _case(vocab, seed=1)
    safe = np.where(labels == -100, 0, labels).astype(np.int32)
    g = np.random.RandomState(2).rand(T).astype(np.float32) / T
    g[labels == -100] = 0.0
    jloss, jlse = _pallas_fwd(jnp.asarray(h), jnp.asarray(w),
                              jnp.asarray(safe), 256, 1024, True)
    jdh, jdw = _pallas_bwd(jnp.asarray(h), jnp.asarray(w), jnp.asarray(safe),
                           jlse, jnp.asarray(g), 256, 1024, True)
    th, tw = torch.from_numpy(h), torch.from_numpy(w)
    ts = torch.from_numpy(safe)
    loss, lse = fc.fused_lm_head_ce_forward(th, tw, ts)
    _close(loss, jloss, rtol=1e-5, atol=1e-5)
    _close(lse, jlse, rtol=1e-5, atol=1e-5)
    dh, dw = fc.fused_lm_head_ce_backward(th, tw, ts, lse,
                                          torch.from_numpy(g))
    _close(dh, jdh, rtol=1e-4, atol=1e-7)
    _close(dw, jdw, rtol=1e-4, atol=1e-7)


def test_token_count_must_tile_block_t():
    h = torch.zeros(300, 8)
    w = torch.zeros(8, 16)
    with pytest.raises(ValueError, match="block_t 256 must divide"):
        fc.fused_lm_head_ce(h, w, torch.zeros(300, dtype=torch.long))
    assert fc.fused_lm_head_ce(h, w, torch.zeros(300, dtype=torch.long),
                               block_t=100).shape == (300,)


def test_backward_takes_a_broadcast_gradient():
    """``losses.sum()`` hands the backward a stride-0 gradient."""
    h, w, labels = _case(2048)
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tl = torch.from_numpy(labels)
    fc.fused_lm_head_ce(th, tw, tl).sum().backward()
    dense_h = th.grad.clone()
    th.grad = None
    tw.grad = None
    g = torch.ones(T)
    torch.autograd.backward(fc.fused_lm_head_ce(th, tw, tl), g)
    assert torch.equal(th.grad, dense_h)


def test_wrappers_raise_on_mixed_devices():
    h, w = torch.zeros(256, 8), torch.zeros(8, 16)
    labels = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(ValueError, match="one CUDA device"):
        fc.fused_lm_head_ce_forward(h, w.to("meta"), labels)
    with pytest.raises(ValueError, match="h must be"):
        fc.fused_lm_head_ce_forward(h, w.T, labels)


@pytest.mark.parametrize("vocab", [256, 2000, 32000, 40000])
def test_backward_workspace_stays_under_half_the_logits(vocab):
    chunk = fc.chunk_columns(vocab)
    assert chunk % 32 == 0 and chunk <= fc.MAX_CHUNK
    assert 2 * chunk < vocab
    splits = fc.forward_splits(8192, vocab)
    assert 1 <= splits <= -(-vocab // 128)


# -- the gate ----------------------------------------------------------------

def _spy_plain_forward(monkeypatch):
    calls = []
    plain = fc.fused_lm_head_ce_forward_reference

    def spy(*args):
        calls.append(args[0].shape)
        return plain(*args)

    monkeypatch.setattr(fc, "fused_lm_head_ce_forward_reference", spy)
    return calls


@pytest.mark.parametrize("flag_on, seq, fused", [(False, 64, False),
                                                  (True, 60, False),
                                                  (True, 64, True)])
def test_gate(flag_on, seq, fused, monkeypatch):
    calls = _spy_plain_forward(monkeypatch)
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    ids = torch.randint(0, 256, (4, seq), generator=torch.Generator()
                        .manual_seed(0))
    flags.set_flags({FLAG: flag_on})
    try:
        h = model.llama(ids)
        assert fc.fused_ce_applies(h) == fused
        loss = model(ids, ids)
    finally:
        flags.set_flags({FLAG: False})
    assert calls == ([(4 * seq, 64)] if fused else [])
    assert loss.dim() == 0 and torch.isfinite(loss)


def test_flags_bootstrap_from_the_environment():
    code = ("from paddle_tpu_torch.core import get_flags, set_flags;"
            "print(get_flags('%s')['%s']);"
            "set_flags({'%s': 'off'});"
            "print(get_flags(['%s']))" % (FLAG, FLAG, FLAG, FLAG))
    env = dict(os.environ, FLAGS_fused_lm_head_ce="1")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.stdout.split("\n")[:2] == ["True", "{'%s': False}" % FLAG]
    assert flags.get_flags(FLAG) == {FLAG: False}


# -- the tiny Llama with the flag on -----------------------------------------

@pytest.fixture
def pair():
    """A fresh reference tiny Llama (fp32) and the port's copy."""
    paddle.seed(0)
    jmodel = JaxLlamaForCausalLM(JaxLlamaConfig.tiny(use_parallel=False))
    names, values = jmodel.functional_state()
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_jax_state(model, names, [np.asarray(v) for v in values])
    return jmodel, model


def _llama_batch():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 256, (4, 64)).astype(np.int32)
    labels = rng.randint(0, 256, (4, 64)).astype(np.int32)
    labels[:, :5] = -100
    return ids, labels


def _jax_fused_step(jmodel, opt):
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    return CompiledTrainStep(jmodel, None, opt, mesh=mesh,
                             labels_to_model=True)


def test_llama_fused_trajectory_matches_compiled_train_step(pair, fused_flag,
                                                            monkeypatch):
    jmodel, model = pair
    calls = _spy_plain_forward(monkeypatch)
    ids, labels = _llama_batch()
    jstep = _jax_fused_step(jmodel, JaxAdamW(
        learning_rate=1e-3, parameters=jmodel.parameters()))
    step = TrainStep(model, None, AdamW(1e-3, parameters=model.parameters()),
                     labels_to_model=True, device="cpu")
    want = [float(jstep(ids, labels)) for _ in range(5)]
    got = [float(step(ids, labels)) for _ in range(5)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    assert len(calls) == 5


def test_llama_fused_first_step_gradients(pair, fused_flag):
    jmodel, model = pair
    ids, labels = _llama_batch()
    names, values = jmodel.functional_state()

    def loss_of(vals):
        with jmodel.bind_state(names, vals):
            with jax_no_grad():
                loss = jmodel(JaxTensor(ids), JaxTensor(labels))
        return loss._value

    # jax.grad traces the forward, so the reference's gate takes the kernel
    want_loss, want_grads = jax.value_and_grad(loss_of)(list(values))
    loss = model(torch.from_numpy(ids), torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    params = dict(model.named_parameters())
    for name, want in zip(names, want_grads):
        want = np.asarray(want)
        np.testing.assert_allclose(params[name].grad.numpy(), want, rtol=1e-3,
                                   atol=1e-5 * float(np.abs(want).max()),
                                   err_msg=name)


def test_llama_fused_matches_unfused_on_the_port(pair):
    _, model = pair
    ids, labels = (torch.from_numpy(x) for x in _llama_batch())
    unfused = model(ids, labels)
    flags.set_flags({FLAG: True})
    try:
        fused = model(ids, labels)
    finally:
        flags.set_flags({FLAG: False})
    np.testing.assert_allclose(fused.item(), unfused.item(), rtol=2e-4)
    logits = model(ids)
    want = F.cross_entropy(logits.reshape(-1, 256), labels.reshape(-1))
    assert want.item() == unfused.item()
    assert port_llama.fused_ce_applies is fc.fused_ce_applies
