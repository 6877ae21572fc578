"""AMP at O2 (``paddle_tpu_torch.amp``) against the JAX package's, on the
CPU: the tiny Llama decorated to bfloat16 or float16 and run under
``auto_cast(level="O2")``, its forward and one ``TrainStep``.

The reference runs compiled, with XLA's excess precision off, as
``tests/test_torch_amp.py`` explains (its dispatcher casts at trace time,
so the compiled program carries the same casts as its eager dispatch).
Weights come across through ``functional_state()`` / ``models.convert
.load_jax_state``; inputs are numpy arrays from a seed.

Checked: the dtype of every decoder layer's output, of each norm's
output and of the logits, equal to the reference's; the loss, the logits
and every gradient within ``tests/test_torch_amp.py``'s limits (loss: bf16
8e-3, float16 1e-3 relative; logits and gradients, per tensor, against
its largest entry: bf16 2e-2, float16 2.5e-3), and the elementwise dtype
rules of O2: a float32 + bfloat16 ``add`` is bfloat16, ``exp`` and
``softmax`` of a bfloat16 tensor are float32, and without AMP that
``add`` is float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
import paddle_tpu.nn.functional as jF
from paddle_tpu.core.dispatch import no_grad as jax_no_grad
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig,
    LlamaForCausalLM as JaxLlamaForCausalLM,
)
from paddle_tpu_torch import amp
from paddle_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    load_jax_state,
)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import SGD
from paddle_tpu_torch.parallel import TrainStep
from torch_threads import one_torch_thread  # noqa: F401

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}
LOSS_RTOL = {"bfloat16": 8e-3, "float16": 1e-3}
GRAD_RTOL = {"bfloat16": 2e-2, "float16": 2.5e-3}
V = 256
LR = 0.5


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _close_to_max(got, want, dtype, what):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=GRAD_RTOL[dtype] * scale, err_msg=what)


def _spots(model):
    """The modules whose output dtypes are held: each decoder layer, each
    norm, and the head."""
    out = {}
    for i, layer in enumerate(model.llama.layers):
        out["layers.%d" % i] = layer
        out["layers.%d.input_layernorm" % i] = layer.input_layernorm
        out["layers.%d.post_attention_layernorm" % i] = \
            layer.post_attention_layernorm
    out["norm"] = model.llama.norm
    out["lm_head"] = model.lm_head
    return out


def _note(seen, name, fmt):
    """A forward hook noting its module's first output dtype (returning
    None: the output stays as it is)."""
    def hook(_module, _inputs, out):
        seen.setdefault(name, fmt(out.dtype))
    return hook


@pytest.fixture(scope="module")
def reference():
    paddle.seed(0)
    jmodel = JaxLlamaForCausalLM(
        JaxLlamaConfig.tiny(use_parallel=False, num_key_value_heads=2))
    names, values = jmodel.functional_state()
    rng = np.random.RandomState(3)
    ids = rng.randint(0, V, (2, 12)).astype(np.int32)
    labels = rng.randint(0, V, (2, 12)).astype(np.int32)
    labels[0, :3] = -100
    runs = {}
    for dtype in DTYPES:
        seen = {}
        hooks = [layer.register_forward_post_hook(_note(seen, n, str))
                 for n, layer in _spots(jmodel).items()]

        def loss_of(vals, dtype=dtype):
            with jmodel.bind_state(names, vals):
                with jax_no_grad(), jamp.auto_cast(level="O2",
                                                   dtype=dtype):
                    logits = jmodel(JaxTensor(ids))
                    loss = jF.cross_entropy(logits.reshape([-1, V]),
                                            JaxTensor(labels.reshape(-1)))
            return loss._value, logits._value

        (loss, logits), grads = _compiled(
            jax.value_and_grad(loss_of, has_aux=True),
            [jnp.asarray(v, dtype) for v in values])
        for h in hooks:
            h.remove()
        runs[dtype] = dict(loss=float(loss), logits=np.asarray(
            logits, np.float32), logits_dtype=str(logits.dtype),
            grads=[np.asarray(g, np.float32) for g in grads],
            dtypes=seen)
    return names, [np.asarray(v) for v in values], ids, labels, runs


def _port_model(names, values, dtype, **kw):
    model = LlamaForCausalLM(LlamaConfig.tiny(num_key_value_heads=2, **kw),
                             device="cpu")
    load_jax_state(model, names, values)
    assert amp.decorate(model, level="O2", dtype=dtype) is model
    assert all(p.dtype == DTYPES[dtype] for p in model.parameters())
    return model


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_o2_forward_matches_the_reference(reference, dtype):
    names, values, ids, labels, runs = reference
    want = runs[dtype]
    model = _port_model(names, values, dtype)
    seen = {}
    hooks = [m.register_forward_hook(
        _note(seen, n, lambda d: str(d).split(".")[-1]))
        for n, m in _spots(model).items()]
    with amp.auto_cast(level="O2", dtype=dtype):
        logits = model(torch.from_numpy(ids).long())
        loss = F.cross_entropy(logits.reshape(-1, V),
                               torch.from_numpy(labels.reshape(-1)).long())
    for h in hooks:
        h.remove()
    assert seen == want["dtypes"]
    assert str(logits.dtype).split(".")[-1] == want["logits_dtype"] == dtype
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), want["loss"],
                               rtol=LOSS_RTOL[dtype])
    _close_to_max(logits.detach().float().numpy(), want["logits"], dtype,
                  "logits")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_o2_train_step_matches_the_reference(reference, dtype):
    """One ``TrainStep`` (forward, backward and an SGD update) under O2:
    the loss and every gradient against the reference's, and each
    parameter moved by ``-lr * grad`` in its own dtype."""
    names, values, ids, labels, runs = reference
    want = runs[dtype]
    model = _port_model(names, values, dtype)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = TrainStep(model, None, SGD(learning_rate=LR,
                                      parameters=model.parameters()),
                     labels_to_model=True, device="cpu")
    with amp.auto_cast(level="O2", dtype=dtype):
        loss = step(torch.from_numpy(ids).long(),
                    torch.from_numpy(labels).long())
    np.testing.assert_allclose(loss.item(), want["loss"],
                               rtol=LOSS_RTOL[dtype])
    params = dict(model.named_parameters())
    for name, g in zip(names, want["grads"]):
        p = params[name]
        assert p.grad.dtype == DTYPES[dtype], name
        _close_to_max(p.grad.float().numpy(), g, dtype, name)
        moved = (before[name] - LR * p.grad).to(p.dtype)
        assert torch.equal(p.detach(), moved), name
    assert amp.amp_state() is None


def test_o2_recompute_keeps_the_state(reference):
    """A recomputed layer re-runs its forward in the backward under the
    O2 state of the forward: the same loss and gradients as without."""
    names, values, ids, labels, _ = reference
    grads = []
    for recompute in (False, True):
        model = _port_model(names, values, "float16", recompute=recompute)
        with amp.auto_cast(level="O2", dtype="float16"):
            loss = model(torch.from_numpy(ids).long(),
                         torch.from_numpy(labels).long())
        loss.backward()
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_o2_dtype_rules_match_the_reference():
    a = np.linspace(0.5, 1.5, 6).astype(np.float32)
    ja, jb = JaxTensor(jnp.asarray(a)), JaxTensor(jnp.asarray(a,
                                                           jnp.bfloat16))
    ta, tb = torch.from_numpy(a), torch.from_numpy(a).bfloat16()
    with jamp.auto_cast(level="O2"):
        want = [ja + jb, paddle.exp(jb), jF.softmax(jb), jb.sum(),
                ja.reshape([2, 3]), ja[1:3]]
    with amp.auto_cast(level="O2"):
        got = [ta + tb, torch.exp(tb), torch.softmax(tb, -1), tb.sum(),
               ta.view(2, 3), ta[1:3], ta.float(), ta.to(torch.float32),
               torch.ones(2), ta.shape]
    names = [str(w.dtype) for w in want]
    assert names == ["bfloat16", "float32", "float32", "float32",
                     "bfloat16", "bfloat16"]
    assert [str(g.dtype).split(".")[-1] for g in got[:6]] == names
    # casts, factories and metadata are no ops: nothing is cast
    assert got[6].dtype == got[7].dtype == got[8].dtype == torch.float32
    assert got[9] == (6,)
    assert str((ja + jb).dtype) == "float32" and (ta + tb).dtype == \
        torch.float32
    # an integer tensor is never cast
    with amp.auto_cast(level="O2"):
        ints = torch.arange(4) * 2
    assert ints.dtype == torch.int64
