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


# -- (g) gradient clipping, LR schedulers and the training recipe ------------

from paddle_tpu.optimizer import clip as jax_clip  # noqa: E402
from paddle_tpu.optimizer import lr as jax_lr  # noqa: E402
from paddle_tpu_torch.optimizer import clip, lr  # noqa: E402


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip_norm", [0.5, 50.0])   # engaged / not
@pytest.mark.parametrize("kind", ["ClipGradByValue", "ClipGradByNorm",
                                  "ClipGradByGlobalNorm"])
def test_clip_matches_reference(kind, clip_norm, dtype):
    rng = np.random.RandomState(8)
    grads = [rng.randn(*shape).astype(np.float32)
             for shape in ((6, 5), (7,), (3, 4, 2))]
    want = getattr(jax_clip, kind)(clip_norm).functional_clip(
        {i: jax.numpy.asarray(g, dtype) for i, g in enumerate(grads)})
    tdtype = getattr(torch, dtype)
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    got = getattr(clip, kind)(clip_norm)(
        [(p, torch.from_numpy(g).to(tdtype)) for p, g in zip(params, grads)])
    for i, (p, g) in enumerate(got):
        assert p is params[i] and g.dtype == tdtype
        # float32: one fp32 rounding of the scale; bf16: the same fp32
        # product rounded to bf16 may land one ulp apart
        tol = (dict(rtol=1e-6, atol=1e-7) if dtype == "float32"
               else dict(rtol=8e-3, atol=0))
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(want[i], np.float32), **tol)
    if kind == "ClipGradByGlobalNorm":
        norm = float(clip.ClipGradByGlobalNorm(clip_norm).global_norm(
            [torch.from_numpy(g) for g in grads]))
        np.testing.assert_allclose(norm, float(jax_clip.ClipGradByGlobalNorm(
            clip_norm).global_norm(grads)), rtol=1e-6)
        assert (norm > clip_norm) == (clip_norm == 0.5)


SCHEDULERS = {
    "NoamDecay": lambda m: m.NoamDecay(64, 4, learning_rate=2.0),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([3, 6], [0.1, 0.05, 0.01]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.1, 0.3),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.1, 0.5),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.1, 5, end_lr=0.01,
                                                   power=2.0, cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.1, T_max=6), 3, 0.0, 0.1),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.1, 0.8),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.1, [2, 5, 9], gamma=0.5),
    "StepDecay": lambda m: m.StepDecay(0.1, 4, gamma=0.3),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(
        0.1, lambda e: 0.9 if e % 2 else 0.95),
    "LambdaDecay": lambda m: m.LambdaDecay(0.1, lambda e: 1.0 / (1 + e)),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(
        0.1, T_max=5, eta_min=0.01),
    "CosineAnnealingWarmRestarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.1, T_0=3, T_mult=2, eta_min=0.001),
    "OneCycleLR": lambda m: m.OneCycleLR(0.1, 10, phase_pct=0.3),
    "CyclicLR": lambda m: m.CyclicLR(0.01, 0.1, 3, mode="triangular2"),
    "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(0.1, patience=1,
                                                   factor=0.5, cooldown=1),
}
PLATEAU_METRICS = [5.0, 4.0, 4.0, 4.0, 3.0, 3.0, 3.0, 3.0, 2.0, 2.5, 2.5, 2.5]


def _advance(sched, i):
    if isinstance(sched, (lr.ReduceOnPlateau, jax_lr.ReduceOnPlateau)):
        sched.step(PLATEAU_METRICS[i])
    else:
        sched.step()


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_lr_scheduler_matches_reference(name):
    assert len(SCHEDULERS) == 16
    make = SCHEDULERS[name]
    sched, jsched = make(lr), make(jax_lr)
    assert isinstance(sched, lr.LRScheduler)
    got, want = [sched()], [jsched()]
    for i in range(12):
        _advance(sched, i)
        _advance(jsched, i)
        got.append(sched.last_lr)
        want.append(jsched.last_lr)
        if i == 5:
            sd = sched.state_dict()
            assert sd == jsched.state_dict()
    assert sched.last_epoch == jsched.last_epoch
    np.testing.assert_allclose(got, want, rtol=1e-12)
    # a fresh scheduler given the mid-run state continues as the first did
    resumed = make(lr)
    resumed.set_state_dict(sd)
    tail = []
    for i in range(6, 12):
        _advance(resumed, i)
        tail.append(resumed.last_lr)
    np.testing.assert_allclose(tail, got[7:], rtol=1e-12)


def test_optimizer_reads_a_scheduler_and_saves_it():
    param = torch.nn.Parameter(torch.ones(3))
    sched = lr.StepDecay(0.1, 1, gamma=0.5)
    opt = AdamW(learning_rate=sched, parameters=[param],
                grad_clip=clip.ClipGradByValue(0.01))
    assert opt.get_lr() == 0.1
    sched.step()
    assert opt.get_lr() == 0.05
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.3)
    param.grad = torch.full((3,), 5.0)
    opt.step()
    sd = opt.state_dict()
    assert sd["LR_Scheduler"]["last_epoch"] == 1
    # the clipped gradient (0.01) is what reached the moments
    np.testing.assert_allclose(sd["moment1/0"].numpy(), 0.1 * 0.01,
                               rtol=1e-6)
    other = AdamW(learning_rate=lr.StepDecay(0.1, 1, gamma=0.5),
                  parameters=[param])
    other.set_state_dict(sd)
    assert other.get_lr() == 0.05 and other.state_dict()["global_step"] == 1
    plain = AdamW(learning_rate=0.2, parameters=[param])
    plain.set_lr(0.3)
    assert plain.get_lr() == 0.3 and "LR_Scheduler" not in plain.state_dict()


def _recipe(mod_lr, opt_cls, clip_cls, params):
    sched = mod_lr.LinearWarmup(mod_lr.CosineAnnealingDecay(1e-3, T_max=10),
                                warmup_steps=2, start_lr=0.0, end_lr=1e-3)
    return sched, opt_cls(learning_rate=sched, parameters=params,
                          grad_clip=clip_cls(RECIPE_CLIP))


RECIPE_CLIP = 0.5


def test_recipe_trajectory_matches_compiled_train_step():
    """AdamW + linear warm-up into cosine decay + global-norm clipping,
    with the fused loss tail on both sides, 5 steps with the scheduler
    stepped after each."""
    from paddle_tpu.core import flags as jax_flags
    from paddle_tpu_torch.core import flags

    paddle.seed(0)
    jmodel = JaxLlamaForCausalLM(JaxLlamaConfig.tiny(use_parallel=False))
    names, values = jmodel.functional_state()
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_jax_state(model, names, [np.asarray(v) for v in values])
    rng = np.random.RandomState(9)
    ids = rng.randint(0, V, (4, 64)).astype(np.int32)
    labels = rng.randint(0, V, (4, 64)).astype(np.int32)
    jsched, jopt = _recipe(jax_lr, JaxAdamW, jax_clip.ClipGradByGlobalNorm,
                           jmodel.parameters())
    sched, opt = _recipe(lr, AdamW, clip.ClipGradByGlobalNorm,
                         model.parameters())
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    flag = {"FLAGS_fused_lm_head_ce": True}
    flags.set_flags(flag)
    jax_flags.set_flags(flag)
    try:
        jstep = CompiledTrainStep(jmodel, None, jopt, mesh=mesh,
                                  labels_to_model=True)
        step = TrainStep(model, None, opt, labels_to_model=True,
                         device="cpu")
        want, got, norms, lrs = [], [], [], []
        for _ in range(5):
            want.append(float(jstep(ids, labels)))
            got.append(float(step(ids, labels)))
            norms.append(float(clip.ClipGradByGlobalNorm(1.0).global_norm(
                [p.grad for p in model.parameters()])))
            lrs.append(opt.get_lr())
            jsched.step()
            sched.step()
    finally:
        flags.set_flags({"FLAGS_fused_lm_head_ce": False})
        jax_flags.set_flags({"FLAGS_fused_lm_head_ce": False})
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)
    assert lrs[0] == 0.0 and lrs[2] == pytest.approx(1e-3)
    assert min(norms) > RECIPE_CLIP   # clipping engaged on every step
    assert got[-1] < got[0]
