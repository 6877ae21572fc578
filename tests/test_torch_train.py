"""The port's training path against the JAX package's, on the same numbers.

Inputs are numpy arrays from a seed; the reference model's weights (and,
for the resume test, its optimizer state) are carried into the port
through ``models.convert``. The port runs on the CPU (``device="cpu"``),
so attention takes the plain forward and backward of the flash kernels.

Tolerances, float32: losses rtol 1e-5 (one step) and 1e-4 over a 5-step
AdamW trajectory (XLA's CPU transcendentals are approximate to ~1e-5
relative and the two sides sum in different orders; Adam's first steps
move every weight by ~lr whatever the gradient's size, which spreads the
gap a little each step). Gradients are held per tensor to atol 1e-5 x
max|grad| and rtol 1e-3, for the same reasons.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as paddle
import paddle_tpu.nn.functional as jF
from paddle_tpu.core.dispatch import no_grad as jax_no_grad
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig,
    LlamaForCausalLM as JaxLlamaForCausalLM,
)
from paddle_tpu.optimizer import Adam as JaxAdam, AdamW as JaxAdamW
from paddle_tpu.parallel.engine import CompiledTrainStep
from paddle_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    export_state,
    load_jax_optimizer_state,
    load_jax_state,
)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import Adam, AdamW, L2Decay
from paddle_tpu_torch.parallel import TrainStep

V = 256   # LlamaConfig.tiny's vocabulary
LOSS_RTOL = 1e-5
TRAJ_RTOL = 1e-4


def _grad_close(got, want, name=""):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5 * scale,
                               err_msg=name)


def _batch(seed, b=2, s=12):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, V, (b, s)).astype(np.int32)
    labels = rng.randint(0, V, (b, s)).astype(np.int32)
    labels[0, :3] = -100   # ignored rows
    return ids, labels


def _jax_loss_fn(logits, labels):
    return jF.cross_entropy(logits.reshape([-1, V]), labels.reshape([-1]))


def _loss_fn(logits, labels):
    return F.cross_entropy(logits.reshape(-1, V), labels.reshape(-1))


@pytest.fixture
def pair():
    """A fresh reference tiny Llama (GQA, fp32) and the port's copy."""
    paddle.seed(0)
    jmodel = JaxLlamaForCausalLM(
        JaxLlamaConfig.tiny(use_parallel=False, num_key_value_heads=2))
    names, values = jmodel.functional_state()
    model = LlamaForCausalLM(LlamaConfig.tiny(num_key_value_heads=2),
                             device="cpu")
    load_jax_state(model, names, [np.asarray(v) for v in values])
    return jmodel, model


def _jax_step(jmodel, lr=1e-3):
    opt = JaxAdamW(learning_rate=lr, parameters=jmodel.parameters())
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    return CompiledTrainStep(jmodel, _jax_loss_fn, opt, mesh=mesh)


def _port_step(model, lr=1e-3):
    opt = AdamW(learning_rate=lr, parameters=model.parameters())
    return TrainStep(model, _loss_fn, opt, device="cpu")


# -- (c) cross-entropy ------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_matches_reference(reduction, dtype):
    rng = np.random.RandomState(1)
    x = (rng.randn(10, 7) * 3).astype(np.float32)
    label = rng.randint(0, 7, (10,)).astype(np.int32)
    label[[2, 5]] = -100
    jx = jax.numpy.asarray(x, dtype=dtype)
    want = jF.cross_entropy(JaxTensor(jx), JaxTensor(label),
                            reduction=reduction)
    want = np.asarray(want._value, dtype=np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = F.cross_entropy(tx, torch.from_numpy(label), reduction=reduction)
    assert got.dtype == (torch.float32 if reduction == "mean"
                         else tx.dtype)
    # bf16 results round to 8 mantissa bits: |loss| < 16 -> 2^-4 apart
    tol = (dict(rtol=1e-5, atol=1e-6) if dtype == "float32"
           else dict(rtol=8e-3, atol=1e-6))
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    if reduction == "none":
        assert not got[[2, 5]].any()


def test_cross_entropy_all_ignored_is_zero():
    x = torch.randn(3, 5)
    label = torch.full((3,), -100)
    assert float(F.cross_entropy(x, label)) == 0.0


# -- (d) the optimizers' update rules ----------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", [1, 7])
@pytest.mark.parametrize("wd", [0.0, 0.05])
@pytest.mark.parametrize("kind", ["adam", "adamw"])
def test_adam_update_rules_match_reference(kind, wd, step, dtype):
    rng = np.random.RandomState(2)
    p = rng.randn(6, 5).astype(np.float32)
    g = rng.randn(6, 5).astype(np.float32)
    m1 = (rng.randn(6, 5) * 0.1).astype(np.float32)
    m2 = np.abs(rng.randn(6, 5) * 0.01).astype(np.float32)
    lr = 0.01
    jcls, cls = (JaxAdam, Adam) if kind == "adam" else (JaxAdamW, AdamW)
    update = jcls(learning_rate=lr, weight_decay=wd)._make_update()
    jp, (jm1, jm2) = update(
        jax.numpy.asarray(p, dtype=dtype), jax.numpy.asarray(g, dtype=dtype),
        (jax.numpy.asarray(m1), jax.numpy.asarray(m2)),
        jax.numpy.asarray(lr, jax.numpy.float32),
        jax.numpy.asarray(step, jax.numpy.int32), wd)

    tdtype = getattr(torch, dtype)
    param = torch.nn.Parameter(torch.from_numpy(p).to(tdtype))
    param.grad = torch.from_numpy(g).to(tdtype)
    opt = cls(learning_rate=lr, parameters=[param],
              weight_decay=L2Decay(wd) if kind == "adam" else wd)
    opt.set_state_dict({"moment1/0": torch.from_numpy(m1),
                        "moment2/0": torch.from_numpy(m2),
                        "global_step": step - 1})
    opt.step()
    assert opt._global_step == step
    state = opt.state_dict()
    # float32: the two sides differ in fp32 rounding only; bf16 params
    # round the same fp32 result to bf16, which may land one ulp apart
    ptol = (dict(rtol=1e-6, atol=1e-7) if dtype == "float32"
            else dict(rtol=8e-3, atol=0))
    np.testing.assert_allclose(param.detach().float().numpy(),
                               np.asarray(jp, np.float32), **ptol)
    # moments: b*m + (1-b)*g may round once (fused) or twice; its terms
    # reach ~0.5 here, where an fp32 ulp is 6e-8
    for key, want in (("moment1/0", jm1), ("moment2/0", jm2)):
        assert state[key].dtype == torch.float32
        np.testing.assert_allclose(state[key].numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)


def test_optimizer_slots_are_float32_and_round_trip():
    param = torch.nn.Parameter(torch.ones(3, dtype=torch.bfloat16))
    param.grad = torch.full((3,), 0.5, dtype=torch.bfloat16)
    opt = AdamW(learning_rate=0.1, parameters=[param])
    opt.step()
    sd = opt.state_dict()
    assert sorted(sd) == ["global_step", "moment1/0", "moment2/0"]
    assert sd["moment1/0"].dtype == torch.float32 and sd["global_step"] == 1
    other = AdamW(learning_rate=0.1, parameters=[param])
    other.set_state_dict(sd)
    assert other.state_dict()["global_step"] == 1
    assert torch.equal(other.state_dict()["moment2/0"], sd["moment2/0"])
    opt.clear_grad()
    assert param.grad is None
    with pytest.raises(ValueError, match="parameters list"):
        AdamW().step()


# -- (e) the tiny Llama, one step and a trajectory ---------------------------

def test_one_step_loss_and_grads_match_value_and_grad(pair):
    jmodel, model = pair
    ids, labels = _batch(3)
    names, values = jmodel.functional_state()

    def loss_of(vals):
        with jmodel.bind_state(names, vals):
            with jax_no_grad():
                loss = _jax_loss_fn(jmodel(JaxTensor(ids)),
                                    JaxTensor(labels))
        return loss._value

    want_loss, want_grads = jax.value_and_grad(loss_of)(list(values))
    loss = model(torch.from_numpy(ids), torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss),
                               rtol=LOSS_RTOL)
    params = dict(model.named_parameters())
    for name, want in zip(names, want_grads):
        _grad_close(params[name].grad.numpy(), np.asarray(want), name)


def test_train_step_trajectory_matches_compiled_train_step(pair):
    jmodel, model = pair
    ids, labels = _batch(4)
    jstep, step = _jax_step(jmodel), _port_step(model)
    want = [float(jstep(ids, labels)) for _ in range(5)]
    got = [float(step(ids, labels)) for _ in range(5)]
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)
    assert got[-1] < got[0]
    names, values = export_state(model)
    jnames, jvalues = jmodel.functional_state()
    jparams = dict(zip(jnames, jvalues))
    for name, value in zip(names, values):
        np.testing.assert_allclose(value, np.asarray(jparams[name]),
                                   rtol=1e-3, atol=1e-5, err_msg=name)


def test_recompute_gives_the_same_gradients(pair):
    _, model = pair
    remat = LlamaForCausalLM(
        LlamaConfig.tiny(num_key_value_heads=2, recompute=True),
        device="cpu")
    load_jax_state(remat, *export_state(model))
    ids, labels = (torch.from_numpy(x) for x in _batch(5))
    losses = []
    for m in (model, remat):
        loss = m(ids, labels)
        loss.backward()
        losses.append(loss.item())
    assert losses[0] == losses[1]
    grads = dict(remat.named_parameters())
    for name, p in model.named_parameters():
        assert torch.equal(p.grad, grads[name].grad), name


def test_resume_from_a_jax_step(pair):
    """Two reference steps; params, moments and the step count carried
    into the port; then one more step on each side. A step returns the
    loss of the weights it starts from, so the step after that one shows
    whether the moments and the step count came across too."""
    jmodel, model = pair
    ids, labels = _batch(6)
    jstep = _jax_step(jmodel, lr=1e-2)
    for _ in range(2):
        jstep(ids, labels)
    names, values = jmodel.functional_state()
    values = [np.asarray(v) for v in values]   # the next step donates them
    load_jax_state(model, names, values)
    step = _port_step(model, lr=1e-2)
    load_jax_optimizer_state(step.optimizer, model, jstep._trainable_names,
                             jstep._opt_state, jstep._step_count)
    assert step.optimizer._global_step == 2
    want = [float(jstep(ids, labels)) for _ in range(2)]
    got = [float(step(ids, labels)) for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    # a fresh optimizer (zero moments, step 1 again) gives another loss
    load_jax_state(model, names, values)
    fresh = _port_step(model, lr=1e-2)
    fresh(ids, labels)
    assert abs(float(fresh(ids, labels)) - want[1]) > 1e-3 * abs(want[1])


def test_load_jax_optimizer_state_validates(pair):
    jmodel, model = pair
    opt = AdamW(parameters=model.parameters())
    names = [n for n, _ in model.named_parameters()]
    slots = {n: [np.zeros(p.shape), np.zeros(p.shape)]
             for n, p in model.named_parameters()}
    with pytest.raises(ValueError, match="missing names"):
        load_jax_optimizer_state(opt, model, names[1:], slots, 1)
    bad = dict(slots, **{names[0]: slots[names[0]][:1]})
    with pytest.raises(ValueError, match="has 1 slots"):
        load_jax_optimizer_state(opt, model, names, bad, 1)
    bad = dict(slots, **{names[0]: [np.zeros(3), np.zeros(3)]})
    with pytest.raises(ValueError, match="has shape"):
        load_jax_optimizer_state(opt, model, names, bad, 1)
    assert opt._global_step == 0 and not opt._slots_of


def test_labels_to_model_and_loss_fn_paths_agree(pair):
    _, model = pair
    model2 = LlamaForCausalLM(LlamaConfig.tiny(num_key_value_heads=2),
                              device="cpu")
    load_jax_state(model2, *export_state(model))
    ids, labels = _batch(7)
    loss_a = TrainStep(model, None, AdamW(parameters=model.parameters()),
                       labels_to_model=True, device="cpu")(ids, labels)
    loss_b = TrainStep(model2, _loss_fn,
                       AdamW(parameters=model2.parameters()),
                       device="cpu")(ids, labels)
    assert loss_a.dim() == 0 and not loss_a.requires_grad
    assert float(loss_a) == float(loss_b)
    for (name, p), q in zip(model.named_parameters(), model2.parameters()):
        assert torch.equal(p.grad, q.grad), name
        assert torch.equal(p, q), name


# -- (f) the device policy -----------------------------------------------------

def test_train_step_and_model_raise_without_cuda(pair, monkeypatch):
    _, model = pair
    opt = AdamW(parameters=model.parameters())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainStep(model, _loss_fn, opt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaForCausalLM(LlamaConfig.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainStep(model, _loss_fn, opt, device="cuda")


def test_train_step_rejects_a_model_on_another_device(pair):
    _, model = pair
    with pytest.raises(ValueError, match="got a model on"):
        TrainStep(model.to("meta"), _loss_fn,
                  AdamW(parameters=model.parameters()), device="cpu")


def test_llama1b_train_preset():
    cfg = LlamaConfig.llama1b_train()
    assert (cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers,
            cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim,
            cfg.vocab_size, cfg.max_position_embeddings, cfg.dtype,
            cfg.recompute) == (2048, 5632, 16, 16, 16, 128, 32000, 2048,
                               "bfloat16", True)
