"""The port's mixed precision (``paddle_tpu_torch.amp``) against the JAX
package's, on the same numbers.

The reference runs compiled where it has a compiled form: its model under
``auto_cast`` inside ``jax.value_and_grad``, compiled (its dispatcher
casts at trace time, so the program carries the casts) with XLA's excess
precision off (``_compiled``): by default XLA keeps the float32 value of
a round trip float32 -> bf16 -> float32 between two ops of a program,
where the reference's eager dispatch, and the port, round at every op
boundary (the tiny ResNet's bf16 gradients moved by up to 22 % of their
largest entry with it on, batch norm amplifying the difference).
Weights come across through ``functional_state()`` / ``models.convert
.load_jax_state``; inputs are numpy arrays from a seed.

Tolerances. Losses: bf16 rtol 8e-3 (``tests/test_torch_train.py``'s bf16
limit: a value rounds to 8 significant bits), float16 1e-3 (11 bits).
Gradients and logits, per tensor, against its largest entry: bf16 2e-2,
float16 2.5e-3, 5 ulps of the dtype at that entry. The two packages
still round at a few other places inside an op (a fused ``linear`` with
its bias, rope and SwiGLU's float32 intermediates) and a gradient sums
many rounded terms: the tiny Llama's worst tensor sits at ~3.5 ulps in
bf16 and ~2.7 in float16, the tiny ResNet's at 1. The tiny ResNet is a
stem, one residual block with its downsample and a head at batch 8,
16 x 16: its batch norms normalise 256 to 2048 values a channel
(ResNet-18's last stage at test sizes sees 2-8, an ill-conditioned step,
as ``tests/test_torch_resnet.py`` explains for float32).

The flash kernels' float16 plain versions are held against the
reference's Pallas kernels in interpret mode at the chip tolerance for
float16 (a quarter of bf16's), and where dS overflows float16 both must
put inf in the same places: the signal ``GradScaler`` skips a step on.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as jF
from paddle_tpu.core.dispatch import no_grad as jax_no_grad
from paddle_tpu.core.tensor import Parameter as JaxParameter
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.kernels.flash_attention import _flash_core, _flash_fwd_bhnd
from paddle_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig,
    LlamaForCausalLM as JaxLlamaForCausalLM,
)
from paddle_tpu.nn import initializer as jinit
from paddle_tpu.optimizer import SGD as JaxSGD
from paddle_tpu.vision.models.resnet import BasicBlock as JaxBasicBlock
import paddle_tpu_torch as paddle_port
from paddle_tpu_torch import amp, nn
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    load_jax_state,
)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import SGD
from paddle_tpu_torch.vision.models.resnet import BasicBlock
from torch_threads import one_torch_thread  # noqa: F401

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}
LOSS_RTOL = {"bfloat16": 8e-3, "float16": 1e-3}
GRAD_RTOL = {"bfloat16": 2e-2, "float16": 2.5e-3}
# the chip's float16 kernel-vs-plain tolerances (chip_smoke.TOL, BWD_TOL)
F16_TOL = dict(atol=5e-3, rtol=2.5e-3)
F16_BWD_TOL = dict(atol=1.25e-3, rtol=2.5e-3)
LSE_TOL = dict(atol=1e-4, rtol=1e-4)
V = 256


def _grads_close(model, names, want_grads, dtype):
    params = dict(model.named_parameters())
    for name, want in zip(names, want_grads):
        want = np.asarray(want, np.float32)
        got = params[name].grad.float().numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=GRAD_RTOL[dtype] * scale,
                                   err_msg=name)


def _traced(fn, names_seen):
    """``fn`` compiled, with the reference dispatcher's AMP casts recorded
    by primitive name while it traces (``maybe_cast_inputs`` wrapped for
    the duration; nothing in the reference is edited)."""
    def run(*args):
        saved = jamp.maybe_cast_inputs

        def record(op_name, leaves):
            names_seen.add(op_name)
            return saved(op_name, leaves)

        jamp.maybe_cast_inputs = record
        try:
            return _compiled(fn, *args)
        finally:
            jamp.maybe_cast_inputs = saved
    return run


def _compiled(fn, *args):
    """``fn(*args)`` compiled without XLA's excess precision: by default
    XLA drops a round trip float32 -> bf16 -> float32 between two ops of
    one program and keeps the float32 value, where the reference's eager
    dispatch rounds at every op boundary (and the port with it). With it
    off, the compiled reference rounds where its eager ops do."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


# -- the models under O1 -----------------------------------------------------

@pytest.fixture(scope="module")
def llama_pair():
    paddle.seed(0)
    jmodel = JaxLlamaForCausalLM(
        JaxLlamaConfig.tiny(use_parallel=False, num_key_value_heads=2))
    names, values = jmodel.functional_state()
    return jmodel, names, [np.asarray(v) for v in values]


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_llama_o1_loss_and_gradients(llama_pair, dtype):
    jmodel, names, values = llama_pair
    rng = np.random.RandomState(3)
    ids = rng.randint(0, V, (2, 12)).astype(np.int32)
    labels = rng.randint(0, V, (2, 12)).astype(np.int32)
    labels[0, :3] = -100
    seen = set()

    def loss_of(vals):
        with jmodel.bind_state(names, vals):
            with jax_no_grad(), jamp.auto_cast(dtype=dtype):
                loss = jmodel(JaxTensor(ids), labels=JaxTensor(labels))
        return loss._value

    want_loss, want_grads = _traced(jax.value_and_grad(loss_of), seen)(
        [jnp.asarray(v) for v in values])
    model = LlamaForCausalLM(LlamaConfig.tiny(num_key_value_heads=2),
                             device="cpu")
    load_jax_state(model, names, values)
    with amp.auto_cast(dtype=dtype):
        loss = model(torch.from_numpy(ids).long(),
                     torch.from_numpy(labels).long())
    loss.backward()
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(want_loss),
                               rtol=LOSS_RTOL[dtype])
    _grads_close(model, names, want_grads, dtype)
    # every listed operation the reference cast here has a cast point
    listed = seen & (jamp.WHITE_LIST | jamp.BLACK_LIST)
    assert listed == {"linear", "rms_norm", "cross_entropy"}
    assert listed <= amp.CAST_POINTS


def test_llama_recompute_keeps_the_amp_state(llama_pair):
    """The backward's recomputation runs under the forward's O1 state:
    the same loss and gradients as without recompute."""
    _, names, values = llama_pair
    models = []
    for recompute in (False, True):
        m = LlamaForCausalLM(LlamaConfig.tiny(num_key_value_heads=2,
                                              recompute=recompute),
                             device="cpu")
        load_jax_state(m, names, values)
        models.append(m)
    ids = torch.from_numpy(np.random.RandomState(4).randint(0, V, (2, 12)))
    losses = []
    for m in models:
        with amp.auto_cast(dtype="float16"):
            loss = m(ids, ids)
        loss.backward()
        losses.append(loss.item())
    assert losses[0] == losses[1]
    grads = dict(models[1].named_parameters())
    for name, p in models[0].named_parameters():
        assert torch.equal(p.grad, grads[name].grad), name


def test_llama_decorated_o1(llama_pair):
    """``decorate`` casts every parameter to bf16; O1 then runs the model
    in bf16 with float32 norms and loss, as the reference's."""
    jmodel, names, values = llama_pair
    ids = np.random.RandomState(5).randint(0, V, (2, 12)).astype(np.int32)
    bvals = [jnp.asarray(v, jnp.bfloat16) for v in values]

    def loss_of(vals):
        with jmodel.bind_state(names, vals):
            with jax_no_grad(), jamp.auto_cast():
                loss = jmodel(JaxTensor(ids), labels=JaxTensor(ids))
        return loss._value

    want_loss, want_grads = _compiled(jax.value_and_grad(loss_of), bvals)
    model = LlamaForCausalLM(LlamaConfig.tiny(num_key_value_heads=2),
                             device="cpu")
    load_jax_state(model, names, values)
    assert amp.decorate(model, dtype="bfloat16") is model
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    with amp.auto_cast():
        loss = model(torch.from_numpy(ids).long(), torch.from_numpy(ids).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss),
                               rtol=LOSS_RTOL["bfloat16"])
    _grads_close(model, names, want_grads, "bfloat16")


def _zero_create(self, shape, dtype=None, name=None):
    return JaxParameter(np.zeros(tuple(int(s) for s in shape), np.float32),
                        name=name)


def _tiny_resnets():
    """A stem (conv 3 -> 8, batch norm, ReLU), a BasicBlock 8 -> 16 at
    stride 2 with its downsample, pooling and a 10-class head: the
    reference's (built with zero weights: its initialisers compile once a
    shape) and the port's."""
    saved = jinit.Initializer.create
    jinit.Initializer.create = _zero_create
    try:
        jdown = jnn.Sequential(jnn.Conv2D(8, 16, 1, stride=2,
                                          bias_attr=False),
                               jnn.BatchNorm2D(16))
        jnet = jnn.Sequential(
            jnn.Conv2D(3, 8, 3, padding=1, bias_attr=False),
            jnn.BatchNorm2D(8), jnn.ReLU(),
            JaxBasicBlock(8, 16, stride=2, downsample=jdown),
            jnn.AdaptiveAvgPool2D(1), jnn.Flatten(), jnn.Linear(16, 10))
    finally:
        jinit.Initializer.create = saved
    gen = torch.Generator().manual_seed(0)
    down = nn.Sequential(nn.Conv2D(8, 16, 1, stride=2, bias_attr=False,
                                   device="cpu"),
                         nn.BatchNorm2D(16, device="cpu"))
    net = nn.Sequential(
        nn.Conv2D(3, 8, 3, padding=1, bias_attr=False, device="cpu"),
        nn.BatchNorm2D(8, device="cpu"), nn.ReLU(),
        BasicBlock(8, 16, stride=2, downsample=down, device="cpu"),
        nn.AdaptiveAvgPool2D(1), nn.Flatten(),
        nn.Linear(16, 10, generator=gen, device="cpu"))
    rng = np.random.RandomState(0)
    tensors = jnet.raw_state_tensors()
    pnames = [n for n, _ in jnet.named_parameters()]
    bnames = [n for n, _ in jnet.named_buffers()]
    pvals = []
    for n in pnames:
        shape = tuple(tensors[n].shape)
        if len(shape) == 4:
            v = (rng.rand(*shape) * 2 - 1) * np.sqrt(6.0 / np.prod(shape[1:]))
        elif len(shape) == 2:
            v = rng.randn(*shape) * np.sqrt(2.0 / sum(shape))
        elif n.endswith("weight"):
            v = 1 + 0.1 * rng.randn(*shape)
        else:
            v = 0.1 * rng.randn(*shape)
        pvals.append(v.astype(np.float32))
        tensors[n]._value = jnp.asarray(pvals[-1])
    bvals = [np.asarray(tensors[n]._value) for n in bnames]
    load_jax_state(net, pnames + bnames, pvals + bvals)
    return jnet, net, pnames, bnames, pvals, bvals


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_tiny_resnet_o1_logits_loss_and_gradients(dtype):
    jnet, net, pnames, bnames, pvals, bvals = _tiny_resnets()
    rng = np.random.RandomState(1)
    x = (rng.rand(8, 3, 16, 16) * 2 - 1).astype(np.float32)
    y = rng.randint(0, 10, (8,)).astype(np.int64)
    seen = set()

    def loss_of(vals):
        jnet.train()
        with jnet.bind_state(pnames + bnames, list(vals) + bvals):
            with jax_no_grad(), jamp.auto_cast(dtype=dtype):
                logits = jnet(JaxTensor(x))
                loss = jF.cross_entropy(logits, JaxTensor(y))
        return loss._value, logits._value

    (want_loss, want_logits), want_grads = _traced(
        jax.value_and_grad(loss_of, has_aux=True), seen)(
        [jnp.asarray(v) for v in pvals])
    with amp.auto_cast(dtype=dtype):
        logits = net(torch.from_numpy(x))
        loss = F.cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    assert logits.dtype == DTYPES[dtype] and loss.dtype == torch.float32
    want_logits = np.asarray(want_logits, np.float32)
    np.testing.assert_allclose(
        logits.float().detach().numpy(), want_logits, rtol=0,
        atol=GRAD_RTOL[dtype] * float(np.abs(want_logits).max()))
    np.testing.assert_allclose(loss.item(), float(want_loss),
                               rtol=LOSS_RTOL[dtype])
    _grads_close(net, pnames, want_grads, dtype)
    listed = seen & (jamp.WHITE_LIST | jamp.BLACK_LIST)
    assert listed == {"conv2d", "batch_norm_train", "linear",
                      "cross_entropy"}
    assert listed <= amp.CAST_POINTS


# -- each cast point's dtypes ------------------------------------------------

def _cast_cases(rng):
    """``(name, reference call, port call, float32 inputs)`` for every cast
    point: the same call on both sides."""
    def r(*shape):
        return rng.randn(*shape).astype(np.float32)

    x2, w2, b = r(4, 6), r(6, 5), r(5)
    img, k = r(2, 3, 6, 6), r(4, 3, 3, 3)
    lab = np.array([1, 0, 4, 2])
    return [
        ("linear", lambda t: jF.linear(*t), lambda t: F.linear(*t),
         (x2, w2, b)),
        ("conv1d", lambda t: jF.conv1d(*t), lambda t: F.conv1d(*t),
         (r(2, 3, 8), r(4, 3, 3))),
        ("conv2d", lambda t: jF.conv2d(*t), lambda t: F.conv2d(*t),
         (img, k, r(4))),
        ("conv3d", lambda t: jF.conv3d(*t), lambda t: F.conv3d(*t),
         (r(1, 3, 4, 4, 4), r(2, 3, 3, 3, 3))),
        ("softmax", lambda t: jF.softmax(*t), lambda t: F.softmax(*t),
         (x2,)),
        ("log_softmax", lambda t: jF.log_softmax(*t),
         lambda t: F.log_softmax(*t), (x2,)),
        ("cross_entropy",
         lambda t: jF.cross_entropy(t[0], JaxTensor(lab), reduction="none"),
         lambda t: F.cross_entropy(t[0], torch.from_numpy(lab),
                                   reduction="none"), (r(4, 5),)),
        ("nll_loss",
         lambda t: jF.nll_loss(t[0], JaxTensor(lab), reduction="none"),
         lambda t: F.nll_loss(t[0], torch.from_numpy(lab),
                              reduction="none"), (r(4, 5),)),
        ("layer_norm", lambda t: jF.layer_norm(t[0], 6, t[1], t[2]),
         lambda t: F.layer_norm(t[0], 6, t[1], t[2]), (x2, r(6), r(6))),
        ("rms_norm", lambda t: jF.rms_norm(*t), lambda t: F.rms_norm(*t),
         (x2, r(6))),
        ("batch_norm_train", lambda t: jF.batch_norm_train(*t),
         lambda t: F.batch_norm_train(*t), (img, r(3), r(3))),
        ("batch_norm_infer", lambda t: jF.batch_norm_infer(*t),
         lambda t: F.batch_norm_infer(*t),
         (img, r(3), np.abs(r(3)) + 0.5, r(3), r(3))),
    ] + [
        # the op layer's listed primitives (the top-level functions)
        (name, lambda t, n=name: getattr(paddle, n)(*t),
         lambda t, n=name: getattr(paddle_port, n)(*t), arrays)
        for name, arrays in (
            ("matmul", (x2, w2)), ("mm", (x2, w2)),
            ("bmm", (r(2, 4, 6), r(2, 6, 5))), ("mv", (x2, r(6))),
            ("addmm", (r(4, 5), x2, w2)), ("exp", (x2,)), ("log", (x2,)),
            ("log2", (x2,)), ("log10", (x2,)), ("log1p", (x2,)),
            ("mean", (x2,)), ("sum", (x2,)), ("cumsum", (x2,)),
            ("logsumexp", (x2,)))
    ] + [
        ("einsum", lambda t: paddle.einsum("ij,jk->ik", *t),
         lambda t: paddle_port.einsum("ij,jk->ik", *t), (x2, w2)),
        ("norm", lambda t: paddle.linalg.norm(*t),
         lambda t: paddle_port.linalg.norm(*t), (x2,)),
    ]


def _dtypes(out):
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return [str(getattr(o, "_value", o).dtype).split(".")[-1] for o in outs]


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_every_cast_point_gives_the_reference_dtypes(dtype):
    """Each cast point called under O1 on float32 inputs and on inputs of
    the AMP dtype: the output dtypes are the reference primitive's."""
    cases = _cast_cases(np.random.RandomState(2))
    assert {name for name, *_ in cases} == amp.CAST_POINTS
    for name, ref_call, port_call, arrays in cases:
        for in_dtype in ("float32", dtype):
            j_in = [JaxTensor(jnp.asarray(a, in_dtype)) for a in arrays]
            t_in = [torch.from_numpy(a).to(getattr(torch, in_dtype))
                    for a in arrays]
            with jamp.auto_cast(dtype=dtype):
                want = _dtypes(ref_call(j_in))
            with amp.auto_cast(dtype=dtype):
                got = _dtypes(port_call(t_in))
            assert got == want, (name, in_dtype, got, want)


# -- GradScaler --------------------------------------------------------------

# steps whose gradient carries an inf (planted) or a NaN
BAD_STEPS = {1: np.inf, 2: np.nan, 5: -np.inf, 9: np.inf, 10: np.inf}


@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
def test_grad_scaler_matches_the_reference(grad_dtype):
    """12 SGD steps on two parameters with non-finite gradients planted:
    the scale, good and bad counts and the skipped steps after each step,
    the parameters, the unscaled gradients and ``state_dict`` exactly."""
    kw = dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=3,
              decr_every_n_nan_or_inf=2)
    rng = np.random.RandomState(6)
    p0 = [rng.randn(4).astype(np.float32), rng.randn(3).astype(np.float32)]
    jparams = [JaxParameter(jnp.asarray(p, grad_dtype)) for p in p0]
    params = [torch.nn.Parameter(torch.from_numpy(p).to(
        getattr(torch, grad_dtype))) for p in p0]
    jopt = JaxSGD(learning_rate=0.5, parameters=jparams)
    opt = SGD(learning_rate=0.5, parameters=params)
    jscaler, scaler = jamp.GradScaler(**kw), amp.GradScaler(**kw)
    for step in range(12):
        grads = [(rng.randn(*p.shape) * jscaler._scale).astype(np.float32)
                 for p in p0]
        if step in BAD_STEPS:
            grads[step % 2][1] = BAD_STEPS[step]
        for jp, p, g in zip(jparams, params, grads):
            jp.grad = JaxTensor(jnp.asarray(g, grad_dtype))
            p.grad = torch.from_numpy(g).to(getattr(torch, grad_dtype))
        jscaler.step(jopt)
        scaler.step(opt)
        assert scaler.state_dict() == jscaler.state_dict(), step
        assert scaler._found_inf == jscaler._found_inf == (step in BAD_STEPS)
        for jp, p in zip(jparams, params):
            np.testing.assert_array_equal(
                p.detach().float().numpy(),
                np.asarray(jp._value, np.float32))
            np.testing.assert_array_equal(
                p.grad.float().numpy(), np.asarray(jp.grad._value,
                                                   np.float32))
        jopt.clear_grad()
        opt.clear_grad()
    assert scaler.get_loss_scaling(device="cpu").item() == float(
        jscaler.get_loss_scaling()._value)
    other = amp.GradScaler()
    other.load_state_dict(jscaler.state_dict())
    assert other.state_dict() == scaler.state_dict()


def test_grad_scaler_scales_a_loss_and_passes_through_when_off():
    loss = torch.tensor(1.5)
    assert amp.GradScaler().scale(loss).item() == 1.5 * 2 ** 15
    off = amp.GradScaler(enable=False)
    assert off.scale(loss) is loss and not off.is_enable()
    p = torch.nn.Parameter(torch.ones(2))
    p.grad = torch.tensor([np.inf, 1.0])
    opt = SGD(learning_rate=1.0, parameters=[p])
    off.step(opt)   # no unscale, no inf check: the step runs
    assert torch.isnan(p).any() or torch.isinf(p).any()


# -- refusals, and the levels and custom lists they used to refuse -----------

@pytest.mark.parametrize("kwargs,match", [
    (dict(level="O0"), "Faults of the reference\" 13"),
    (dict(level="O3", dtype="float16"), "Faults of the reference\" 13"),
    (dict(custom_white_list=["no_such_op"]),
     "no_such_op has no primitive in the port"),
    (dict(custom_black_list=["exp", "no_op_a", "no_op_b"]),
     "no_op_a, no_op_b have no primitive"),
])
def test_auto_cast_refuses(kwargs, match):
    with pytest.raises(NotImplementedError, match=match):
        with amp.auto_cast(**kwargs):
            pass
    assert amp.amp_state() is None


def _mm(t):
    return t[0].reshape([3, 1]) @ t[1].reshape([1, 3])


@pytest.mark.parametrize("kwargs,ref_call,port_call,inputs", [
    # O2 casts every primitive off the black list, tensor operators of
    # model code included, and keeps the black list in float32
    (dict(level="O2"), lambda t: t[0] + t[1], lambda t: t[0] + t[1],
     ("float32", "bfloat16")),
    (dict(level="O2", dtype="float16"), lambda t: t[0] * t[1],
     lambda t: t[0] * t[1], ("float32", "float32")),
    (dict(level="O2"), lambda t: paddle.exp(t[1]),
     lambda t: torch.exp(t[1]), ("float32", "bfloat16")),
    (dict(level="O2"), lambda t: t[0].reshape([3]),
     lambda t: t[0].view(3), ("float32", "float32")),
    # the custom lists that used to be refused: matmul, exp and mean
    (dict(custom_white_list=["matmul"]), _mm, _mm, ("float32", "float32")),
    (dict(custom_black_list=["exp", "mean"]), lambda t: paddle.exp(t[1]),
     lambda t: paddle_port.exp(t[1]), ("float32", "bfloat16")),
    (dict(custom_black_list=["exp", "mean"]), lambda t: t[1].mean(),
     lambda t: t[1].mean(), ("float32", "bfloat16")),
    (dict(level="O2", custom_white_list=["mean"]),
     lambda t: paddle.mean(t[0]), lambda t: paddle_port.mean(t[0]),
     ("float32", "float32")),
    (dict(custom_white_list=["add"]), lambda t: t[0] + t[1],
     lambda t: t[0] + t[1], ("float32", "float32")),
])
def test_auto_cast_levels_and_custom_lists_match_the_reference(
        kwargs, ref_call, port_call, inputs):
    """The port's result dtype and values are the reference's for the
    same call under the same ``auto_cast``: tensor operators, reshapes,
    reductions and the listed primitives, at O2 and through custom lists
    at O1."""
    rng = np.random.RandomState(9)
    arrays = [rng.rand(3).astype(np.float32) + 0.5 for _ in inputs]
    with jamp.auto_cast(**kwargs):
        want = ref_call([JaxTensor(jnp.asarray(a, d))
                         for a, d in zip(arrays, inputs)])
    with amp.auto_cast(**kwargs):
        got = port_call([torch.from_numpy(a).to(getattr(torch, d))
                         for a, d in zip(arrays, inputs)])
    assert str(got.dtype).split(".")[-1] == str(want.dtype), (got.dtype,
                                                             want.dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want._value, np.float32),
                               rtol=1e-2)
    assert amp.amp_state() is None


def test_auto_cast_custom_lists_and_state():
    x, w = torch.randn(2, 3), torch.randn(3, 4)
    with amp.auto_cast(custom_black_list=["linear"]):
        assert F.linear(x, w).dtype == torch.float32
        with amp.auto_cast(enable=False):
            assert amp.amp_state() is None
        with amp.auto_cast(dtype="float16",
                           custom_white_list=["softmax"]):
            assert F.softmax(x).dtype == torch.float16
        assert amp.amp_state()["dtype"] == torch.bfloat16
    assert amp.amp_state() is None and F.linear(x, w).dtype == torch.float32
    with pytest.raises(ValueError, match="bfloat16 or float16"):
        with amp.auto_cast(dtype="float32"):
            pass


@pytest.mark.parametrize("kwargs", [dict(master_weight=True),
                                    dict(save_dtype="float32"),
                                    dict(level="O1")])
def test_decorate_refuses_the_arguments_the_reference_ignores(kwargs):
    with pytest.raises(NotImplementedError, match="Faults of the reference"
                       "\" 14"):
        amp.decorate(torch.nn.Linear(2, 2), **kwargs)


def test_decorate_casts_parameters_and_buffers():
    bn = nn.BatchNorm2D(3, device="cpu")
    opt = object()
    out, same_opt = amp.decorate(bn, opt, dtype="float16")
    assert out is bn and same_opt is opt
    assert bn.weight.dtype == bn._mean.dtype == torch.float16
    assert amp.decorate([bn], dtype="bfloat16") == [bn]
    assert bn._variance.dtype == torch.bfloat16


# -- the flash kernels' float16 plain versions ---------------------------------

def _fold16(x):
    b, n, h, d = x.shape
    return jnp.swapaxes(jnp.asarray(x, jnp.float16), 1, 2).reshape(
        b * h, n, d)


def _unfold(x, b, h):
    x = np.asarray(x, np.float32)
    return np.swapaxes(x.reshape(b, h, x.shape[1], x.shape[2]), 1, 2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_float16_plain_forward_against_pallas(d, causal):
    b, n, h = 2, 128, 2
    rng = np.random.RandomState(d + causal)
    q, k, v = (rng.randn(b, n, h, d).astype(np.float32) for _ in range(3))
    out, lse = fa.flash_attention(
        *(torch.from_numpy(x).half() for x in (q, k, v)), causal=causal)
    assert out.dtype == torch.float16 and lse.dtype == torch.float32
    want, want_lse = _flash_fwd_bhnd(_fold16(q), _fold16(k), _fold16(v),
                                     1.0 / math.sqrt(d), causal, 64, 64,
                                     True)
    np.testing.assert_allclose(out.float().numpy(), _unfold(want, b, h),
                               **F16_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[:, 0],
                               **LSE_TOL)


@pytest.mark.parametrize("grad_scale", [1.0, 1.5e4])
@pytest.mark.parametrize("causal", [True, False])
def test_float16_plain_backward_against_pallas(causal, grad_scale):
    """dq, dk, dv of the plain version against ``jax.vjp`` of the
    reference's Pallas kernels in interpret mode (B*H = 2, N = 256,
    blocks 64/128). At ``grad_scale`` 1.5e4 (dO clipped to float16's
    range) dS = P (dP - delta) passes float16's range in the causal first
    rows, where a few keys share a row's weight: both put inf and NaN in
    the same places and agree on every finite entry."""
    b, n, h, d = 1, 256, 2, 64
    rng = np.random.RandomState(7 + causal)
    q, k, v = (rng.randn(b, n, h, d).astype(np.float32) for _ in range(3))
    g = np.clip(rng.randn(b, n, h, d) * grad_scale, -6e4, 6e4).astype(
        np.float32)
    scale = 1.0 / math.sqrt(d)
    _, vjp = jax.vjp(
        lambda a, b_, c: _flash_core(a, b_, c, None, scale, causal, 64, 128,
                                     True),
        _fold16(q), _fold16(k), _fold16(v))
    want = [_unfold(x, b, h) for x in vjp(_fold16(g))]
    tq, tk, tv, tg = (torch.from_numpy(x).half() for x in (q, k, v, g))
    out, lse = fa.flash_attention(tq, tk, tv, causal=causal)
    got = fa.flash_attention_backward(tq, tk, tv, out, lse, tg,
                                      causal=causal)
    for part, x, y in zip("qkv", got, want):
        x = x.float().numpy()
        np.testing.assert_array_equal(np.isnan(x), np.isnan(y), part)
        np.testing.assert_array_equal(np.isinf(x), np.isinf(y), part)
        ok = np.isfinite(y)
        assert ok.any(), part
        np.testing.assert_allclose(
            x[ok], y[ok], rtol=F16_BWD_TOL["rtol"],
            atol=F16_BWD_TOL["atol"] * float(np.abs(y[ok]).max()),
            err_msg=part)
    if grad_scale > 1.0 and causal:
        assert not all(np.isfinite(y).all() for y in want)
