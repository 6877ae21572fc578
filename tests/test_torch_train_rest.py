"""The rest of the port's training path against the JAX package's: the
fused QKV/MLP Llama, ``TrainStep.run_steps`` and ``loss_reduction``, and
the branches of ``cross_entropy``, ``softmax_with_cross_entropy`` and
``nll_loss``.

Inputs are numpy arrays from a seed; reference weights are carried into
the port by name through ``models.convert``. The port runs on the CPU
(``device="cpu"``).

Tolerances, float32: logits rtol 1e-4 / atol 1e-5 and losses rtol 1e-5
(XLA's CPU transcendentals are approximate to ~1e-5 relative, sums run
in other orders), 3-step trajectories and the weights after them rtol
1e-4 (Adam moves each weight by ~lr whatever its gradient, which spreads
the gap a little each step); loss functions and their gradients rtol
1e-5 / atol 1e-6, bfloat16 rtol 1e-2 (8 mantissa bits, rounded at other
points on the two sides). Port against port (fused against unfused,
``run_steps`` against ``__call__``) runs the same arithmetic: exact, or
rtol 1e-6 where a wider GEMM may sum in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as paddle
import paddle_tpu.nn.functional as jF
from paddle_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig,
    LlamaForCausalLM as JaxLlamaForCausalLM,
)
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.optimizer import lr as jax_lr
from paddle_tpu.parallel.engine import CompiledTrainStep
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    export_state,
    load_jax_state,
)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW, lr
from paddle_tpu_torch.parallel import TrainStep
from paddle_tpu_torch.serving import Engine

V = 256   # LlamaConfig.tiny's vocabulary
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_RTOL = 1e-5
TRAJ_RTOL = 1e-4
FN_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
FUSED = dict(fuse_attention_qkv=True, fuse_mlp=True)


def _batch(seed, b=2, s=12, k=None):
    rng = np.random.RandomState(seed)
    shape = (b, s) if k is None else (k, b, s)
    ids = rng.randint(0, V, shape).astype(np.int32)
    labels = rng.randint(0, V, shape).astype(np.int32)
    labels[..., 0, :3] = -100   # ignored rows
    return ids, labels


def _jax_loss_fn(logits, labels):
    return jF.cross_entropy(logits.reshape([-1, V]), labels.reshape([-1]))


def _loss_fn(logits, labels):
    return F.cross_entropy(logits.reshape(-1, V), labels.reshape(-1))


def _jax_model(**kw):
    paddle.seed(0)
    return JaxLlamaForCausalLM(JaxLlamaConfig.tiny(
        use_parallel=False, num_key_value_heads=2, **kw))


def _port_model(names, values, **kw):
    model = LlamaForCausalLM(LlamaConfig.tiny(num_key_value_heads=2, **kw),
                             device="cpu")
    load_jax_state(model, names, [np.asarray(v) for v in values])
    return model


@pytest.fixture
def fused_pair():
    """A fresh reference tiny Llama with both fused projections and the
    port's copy."""
    jmodel = _jax_model(**FUSED)
    names, values = jmodel.functional_state()
    return jmodel, _port_model(names, values, **FUSED)


def _jax_step(jmodel, learning_rate=1e-3):
    opt = JaxAdamW(learning_rate=learning_rate,
                   parameters=jmodel.parameters())
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    return CompiledTrainStep(jmodel, _jax_loss_fn, opt, mesh=mesh)


def _port_step(model, learning_rate=1e-3, **kw):
    opt = AdamW(learning_rate=learning_rate, parameters=model.parameters())
    return TrainStep(model, _loss_fn, opt, device="cpu", **kw)


def _fuse_weights(names, arrays, qkv=True, mlp=True):
    """An unfused state's weights (or gradients) as the fused model's:
    the q/k/v and gate/up column blocks concatenated in the fused
    layout."""
    state = dict(zip(names, arrays))
    groups = []
    if qkv:
        groups.append(("qkv_proj", ("q_proj", "k_proj", "v_proj")))
    if mlp:
        groups.append(("gate_up_proj", ("gate_proj", "up_proj")))
    out = {}
    for name, value in state.items():
        for fused, parts in groups:
            if "." + parts[0] + "." in name:
                out[name.replace(parts[0], fused)] = np.concatenate(
                    [state[name.replace(parts[0], p)] for p in parts],
                    axis=1)
                break
            if any("." + p + "." in name for p in parts):
                break
        else:
            out[name] = value
    return list(out), list(out.values())


# -- the fused QKV / MLP Llama -----------------------------------------------

def test_fused_parameter_names_are_the_reference_names(fused_pair):
    jmodel, model = fused_pair
    jnames, jvalues = jmodel.functional_state()
    names, values = export_state(model)
    assert sorted(names) == sorted(jnames)
    assert "llama.layers.0.self_attn.qkv_proj.weight" in names
    assert "llama.layers.1.mlp.gate_up_proj.weight" in names
    assert not any(p in n for n in names
                   for p in (".q_proj.", ".gate_proj.", ".up_proj."))
    jstate = dict(zip(jnames, jvalues))
    for name, value in zip(names, values):
        np.testing.assert_array_equal(value, np.asarray(jstate[name]))
    # H = 4, H_kv = 2, D = 16: (4 + 2 * 2) * 16 columns; gate and up 2 x 128
    params = dict(model.named_parameters())
    assert params["llama.layers.0.self_attn.qkv_proj.weight"].shape == \
        (64, 128)
    assert params["llama.layers.0.mlp.gate_up_proj.weight"].shape == \
        (64, 256)


def test_fused_logits_match_reference(fused_pair):
    jmodel, model = fused_pair
    ids = np.random.RandomState(0).randint(0, V, (2, 12)).astype(np.int32)
    want = np.asarray(jmodel(paddle.to_tensor(ids))._value)
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, **LOGIT_TOL)


def test_fused_trajectory_matches_compiled_train_step(fused_pair):
    jmodel, model = fused_pair
    ids, labels = _batch(1)
    jstep, step = _jax_step(jmodel), _port_step(model)
    want = [float(jstep(ids, labels)) for _ in range(3)]
    got = [float(step(ids, labels)) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)
    assert got[-1] < got[0]
    jstate = dict(zip(*jmodel.functional_state()))
    for name, value in zip(*export_state(model)):
        np.testing.assert_allclose(value, np.asarray(jstate[name]),
                                   rtol=1e-3, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("qkv,mlp", [(True, False), (False, True),
                                     (True, True)],
                         ids=["qkv", "mlp", "both"])
def test_fused_equals_unfused_with_concatenated_weights(qkv, mlp):
    """Loss and gradients: the fused model's gradient is the unfused
    gradients' column blocks, concatenated."""
    names, values = _jax_model().functional_state()
    values = [np.asarray(v) for v in values]
    plain = _port_model(names, values)
    fused = _port_model(*_fuse_weights(names, values, qkv, mlp),
                        fuse_attention_qkv=qkv, fuse_mlp=mlp)
    ids, labels = (torch.from_numpy(x).long() for x in _batch(2))
    losses = []
    for m in (plain, fused):
        loss = m(ids, labels)
        loss.backward()
        losses.append(loss.item())
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)
    want = dict(zip(*_fuse_weights(
        *zip(*[(n, p.grad.numpy()) for n, p in plain.named_parameters()]),
        qkv, mlp)))
    got = {n: p.grad.numpy() for n, p in fused.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        np.testing.assert_allclose(g, want[name], rtol=1e-5, atol=1e-7,
                                   err_msg=name)


@pytest.mark.parametrize("flag_names", [(), ("FLAGS_serving_prefix_cache",
                                              "FLAGS_serving_chunked_prefill")],
                         ids=["tier1", "prefix_chunked"])
def test_fused_model_serves_the_unfused_tokens(flag_names):
    """The serving path (the engine's external-cache hook) through the
    fused projections gives the unfused model's greedy tokens."""
    jmodel = _jax_model()
    names, values = jmodel.functional_state()
    values = [np.asarray(v) for v in values]
    models = [_port_model(names, values),
              _port_model(*_fuse_weights(names, values), **FUSED)]
    prompts = [np.random.RandomState(s).randint(0, V, (n,)).tolist()
               for s, n in ((3, 9), (4, 14), (5, 5))]
    outs = []
    flags.set_flags(dict.fromkeys(flag_names, True))
    try:
        for m in models:
            eng = Engine(m, device="cpu", max_slots=2, num_blocks=64,
                         block_size=4, prefill_chunk=4)
            ids = [eng.add_request(p, max_new_tokens=6) for p in prompts]
            eng.run()
            outs.append([eng.output(i) for i in ids])
    finally:
        flags.set_flags(dict.fromkeys(flag_names, False))
    assert outs[1] == outs[0]
    assert all(len(o) == 6 for o in outs[0])


# -- run_steps and loss_reduction --------------------------------------------

def test_run_steps_equals_k_calls():
    jmodel = _jax_model()
    names, values = jmodel.functional_state()
    a, b = _port_model(names, values), _port_model(names, values)
    ids, labels = _batch(3, k=3)
    step_a, step_b = _port_step(a), _port_step(b)
    window = step_a.run_steps(ids, labels)
    calls = [step_b(ids[i], labels[i]) for i in range(3)]
    assert window.dtype == torch.float32 and window.dim() == 0
    assert not window.requires_grad
    assert torch.equal(window, calls[-1])
    assert step_a.optimizer._global_step == step_b.optimizer._global_step \
        == 3
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
        assert torch.equal(p.grad, q.grad), name


def test_run_steps_with_labels_to_model():
    jmodel = _jax_model(**FUSED)
    names, values = jmodel.functional_state()
    a, b = (_port_model(names, values, **FUSED) for _ in range(2))
    ids, labels = _batch(4, k=2)
    step_a = TrainStep(a, None, AdamW(parameters=a.parameters()),
                       labels_to_model=True, device="cpu")
    step_b = _port_step(b, learning_rate=0.001)
    got = step_a.run_steps(ids, labels)
    want = step_b.run_steps(ids, labels)
    assert float(got) == float(want)
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)


def test_run_steps_matches_reference_with_a_window_shared_lr():
    """Two windows of K = 3 under a StepDecay that the caller steps once
    per window: on both sides the three steps of a window share one rate
    and the step counter (bias correction) advances per step."""
    jmodel = _jax_model()
    names, values = jmodel.functional_state()
    values = [np.asarray(v) for v in values]   # the JAX steps donate them
    model = _port_model(names, values)
    jsched = jax_lr.StepDecay(1e-3, step_size=1, gamma=0.25)
    sched = lr.StepDecay(1e-3, step_size=1, gamma=0.25)
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    jstep = CompiledTrainStep(
        jmodel, _jax_loss_fn,
        JaxAdamW(learning_rate=jsched, parameters=jmodel.parameters()),
        mesh=mesh)
    step = TrainStep(model, _loss_fn,
                     AdamW(learning_rate=sched, parameters=model.parameters()),
                     device="cpu")
    batches = [_batch(5, k=3), _batch(6, k=3)]
    want, got = [], []
    for ids, labels in batches:
        want.append(float(jstep.run_steps(ids, labels)))
        got.append(float(step.run_steps(ids, labels)))
        jsched.step()
        sched.step()
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)
    assert jstep._step_count == step.optimizer._global_step == 6
    jstate = dict(zip(*jmodel.functional_state()))
    for name, value in zip(*export_state(model)):
        np.testing.assert_allclose(value, np.asarray(jstate[name]),
                                   rtol=1e-3, atol=1e-5, err_msg=name)
    # the same six batches as per-step calls with the scheduler stepped
    # per call: another trajectory (the window really shared one rate)
    other = _port_model(names, values)
    osched = lr.StepDecay(1e-3, step_size=1, gamma=0.25)
    ostep = TrainStep(other, _loss_fn,
                      AdamW(learning_rate=osched,
                            parameters=other.parameters()), device="cpu")
    for ids, labels in batches:
        for i in range(3):
            last = float(ostep(ids[i], labels[i]))
            osched.step()
    assert abs(last - got[-1]) > 1e-4 * abs(got[-1])


def test_run_steps_rejects_ragged_windows():
    jmodel = _jax_model()
    step = _port_step(_port_model(*jmodel.functional_state()))
    ids, labels = _batch(7, k=2)
    with pytest.raises(ValueError, match="leading K"):
        step.run_steps(ids, labels[:1])
    with pytest.raises(ValueError, match="leading K"):
        step.run_steps(ids[:0], labels[:0])


@pytest.mark.parametrize("reduction", ["mean", "sum", "max", None])
def test_loss_reduction_validation(reduction):
    jmodel = _jax_model()
    names, values = jmodel.functional_state()
    model = _port_model(names, values)
    if reduction in ("mean", "sum"):
        step = _port_step(model, loss_reduction=reduction)
        assert step.loss_reduction == reduction
        return
    msg = "loss_reduction must be 'mean' or 'sum', got %r" % (reduction,)
    with pytest.raises(ValueError) as want:
        _jax_step(jmodel).__class__(
            jmodel, _jax_loss_fn, JaxAdamW(parameters=jmodel.parameters()),
            mesh=Mesh(np.array(jax.devices()[:1]), ("dp",)),
            loss_reduction=reduction)
    assert str(want.value) == msg
    with pytest.raises(ValueError) as got:
        _port_step(model, loss_reduction=reduction)
    assert str(got.value) == msg


# -- cross_entropy, softmax_with_cross_entropy, nll_loss ----------------------

def _logits(seed, shape, positive=False):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2).astype(np.float32)
    if positive:   # probabilities for use_softmax=False, one exact zero
        x = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
        x[0, 0] = 0.0
    return x


def _labels(seed, shape, n_cls, ignored=(1, 4)):
    lbl = np.random.RandomState(seed).randint(0, n_cls, shape).astype(
        np.int32)
    lbl.reshape(-1)[list(ignored)] = -100
    return lbl


CE_CASES = {
    "hard": lambda: dict(x=_logits(0, (6, 5)), label=_labels(1, (6,), 5)),
    "hard_label_n1": lambda: dict(x=_logits(0, (6, 5)),
                                  label=_labels(1, (6, 1), 5)),
    "weight": lambda: dict(x=_logits(2, (6, 5)), label=_labels(3, (6,), 5),
                           weight=np.linspace(0.2, 2.0, 5, dtype=np.float32)),
    "soft_label": lambda: dict(x=_logits(4, (6, 5)),
                               label=_logits(5, (6, 5), positive=True),
                               soft_label=True),
    "label_smoothing": lambda: dict(x=_logits(6, (6, 5)),
                                    label=_labels(7, (6,), 5),
                                    label_smoothing=0.1),
    "smoothing_weight": lambda: dict(
        x=_logits(8, (6, 5)), label=_labels(9, (6,), 5),
        label_smoothing=0.2, weight=np.linspace(1.5, 0.5, 5,
                                                dtype=np.float32)),
    "no_softmax": lambda: dict(x=_logits(10, (6, 5), positive=True),
                               label=_labels(11, (6,), 5),
                               use_softmax=False),
    "axis1": lambda: dict(x=_logits(12, (3, 5, 4)),
                          label=_labels(13, (3, 4), 5), axis=1,
                          label_smoothing=0.1),
    "axis1_hard": lambda: dict(x=_logits(14, (3, 5, 4)),
                               label=_labels(15, (3, 1, 4), 5), axis=1),
    "all_ignored_weight": lambda: dict(
        x=_logits(16, (3, 5)), label=np.full((3,), -100, np.int32),
        weight=np.ones(5, np.float32)),
}


def _cotangent(shape, seed=20):
    return np.asarray(np.random.RandomState(seed).randn(*shape),
                      np.float32)


def _port_value_and_grad(fn, x, dtype=torch.float32, **kw):
    tx = torch.tensor(x, dtype=dtype, requires_grad=True)
    out = fn(tx, **kw)
    outs = out if isinstance(out, tuple) else (out,)
    total = sum((o.float() * torch.from_numpy(_cotangent(o.shape, 20 + i))
                 ).sum() for i, o in enumerate(outs))
    total.backward()
    return [o.detach().float().numpy() for o in outs], tx.grad.float().numpy()


def _jax_value_and_grad(fn, x, dtype=jnp.float32, **kw):
    def scalar(jx):
        out = fn(jx, **kw)
        outs = out if isinstance(out, tuple) else (out,)
        outs = [getattr(o, "_value", o) for o in outs]
        total = sum((o.astype(jnp.float32)
                     * jnp.asarray(_cotangent(o.shape, 20 + i))).sum()
                    for i, o in enumerate(outs))
        return total, outs
    (_, outs), grad = jax.value_and_grad(scalar, has_aux=True)(
        jnp.asarray(x, dtype))
    return ([np.asarray(o, np.float32) for o in outs],
            np.asarray(grad, np.float32))


def _port_kw(kw):
    return {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
            for k, v in kw.items()}


def _jax_kw(kw):
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in kw.items()}


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("case", sorted(CE_CASES))
def test_cross_entropy_branches_match_reference(case, reduction):
    kw = CE_CASES[case]()
    x = kw.pop("x")
    kw["reduction"] = reduction
    got, gx = _port_value_and_grad(
        lambda t, **k: F.cross_entropy(t, **k), x, **_port_kw(kw))
    want, wx = _jax_value_and_grad(
        lambda t, **k: jF.cross_entropy.raw_fn(t, **k), x, **_jax_kw(kw))
    np.testing.assert_allclose(got[0], want[0], **FN_TOL)
    np.testing.assert_allclose(gx, wx, **FN_TOL)


@pytest.mark.parametrize("case", ["weight", "label_smoothing",
                                  "soft_label", "hard"])
def test_cross_entropy_bfloat16_matches_reference(case):
    kw = CE_CASES[case]()
    x = kw.pop("x")
    got, gx = _port_value_and_grad(
        lambda t, **k: F.cross_entropy(t, **k), x, dtype=torch.bfloat16,
        **_port_kw(kw))
    want, wx = _jax_value_and_grad(
        lambda t, **k: jF.cross_entropy.raw_fn(t, **k), x,
        dtype=jnp.bfloat16, **_jax_kw(kw))
    np.testing.assert_allclose(got[0], want[0], **BF16_TOL)
    np.testing.assert_allclose(gx, wx, **BF16_TOL)


@pytest.mark.parametrize("return_softmax", [False, True])
@pytest.mark.parametrize("case", ["hard", "soft_label", "axis1_hard"])
def test_softmax_with_cross_entropy_matches_reference(case, return_softmax):
    kw = CE_CASES[case]()
    x = kw.pop("x")
    kw["return_softmax"] = return_softmax
    got, gx = _port_value_and_grad(
        lambda t, **k: F.softmax_with_cross_entropy(t, **k), x,
        **_port_kw(kw))
    want, wx = _jax_value_and_grad(
        lambda t, **k: jF.softmax_with_cross_entropy(t, **k), x,
        **_jax_kw(kw))
    assert len(got) == len(want) == (2 if return_softmax else 1)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **FN_TOL)
    np.testing.assert_allclose(gx, wx, **FN_TOL)


NLL_CASES = {
    "2d": lambda: dict(x=_logits(30, (6, 5)), label=_labels(31, (6,), 5)),
    "2d_weight": lambda: dict(x=_logits(32, (6, 5)),
                              label=_labels(33, (6,), 5),
                              weight=np.linspace(0.3, 1.7, 5,
                                                 dtype=np.float32)),
    "4d": lambda: dict(x=_logits(34, (2, 5, 3, 4)),
                       label=_labels(35, (2, 3, 4), 5)),
    "4d_weight_ignore": lambda: dict(
        x=_logits(36, (2, 5, 3, 4)), label=_labels(37, (2, 3, 4), 5,
                                                   ignored=(0, 7, 20)),
        weight=np.linspace(2.0, 0.1, 5, dtype=np.float32)),
}


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("case", sorted(NLL_CASES))
def test_nll_loss_matches_reference(case, reduction):
    kw = NLL_CASES[case]()
    x = kw.pop("x")
    kw["reduction"] = reduction
    got, gx = _port_value_and_grad(lambda t, **k: F.nll_loss(t, **k), x,
                                   **_port_kw(kw))
    want, wx = _jax_value_and_grad(
        lambda t, **k: jF.nll_loss.raw_fn(t, **k), x, **_jax_kw(kw))
    np.testing.assert_allclose(got[0], want[0], **FN_TOL)
    np.testing.assert_allclose(gx, wx, **FN_TOL)


def test_loss_functions_reject_unknown_reductions():
    x, label = torch.zeros(2, 3), torch.zeros(2, dtype=torch.long)
    for fn in (F.cross_entropy, F.nll_loss):
        with pytest.raises(ValueError, match="reduction"):
            fn(x, label, reduction="avg")
