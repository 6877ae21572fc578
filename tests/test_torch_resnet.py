"""The port's ResNet family (``paddle_tpu_torch.vision.models``) against
the JAX package's, on the same weights.

The reference builds each model with zero weights (its JAX initialisers
compile once per shape, ~16 s for a ResNet-18 on the CPU); the weights
are drawn with numpy from a seed (convolutions KaimingUniform, the
classifier XavierNormal, batch-norm scales around 1, shifts around 0),
set into the reference model and carried into the port's by
``models.convert.load_jax_state``, running statistics included.

The reference side runs compiled: ``functional_call`` under
``jax.value_and_grad`` for the loss and gradients (the running
statistics the training forward leaves read back inside the trace), and
the reference Momentum's own update rule through ``functional_apply``
(the rule its eager ``step()`` applies). The eager loop computes the same
numbers and takes ~22 s a step on the CPU.

The training check runs ResNet-18 at 64 x 64, batch 2. At 32 x 32 the
last stage sees 1 x 1 maps, so each of its batch norms normalises two
values a channel; their gradient is then a difference of nearly equal
numbers (rounding noise in both packages: the first step's gradients
differ by ~1 % between the reference's eager and compiled paths). At
64 x 64 the last stage's maps are 2 x 2, and the two packages agree
to ~1.5e-5 of each gradient's largest entry.

Tolerance: 1e-4 of the largest magnitude of each reference array for
the whole model (logits, loss, gradients, parameters after a step,
running statistics), 1e-5 for a block alone.
"""
import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as jF
import paddle_tpu.vision.models as jmodels
from paddle_tpu.core.tensor import Parameter as JaxParameter
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.nn import initializer as jinit
from paddle_tpu_torch.models import export_state, load_jax_state
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.parallel import TrainStep
from paddle_tpu_torch.vision import models
from torch_threads import one_torch_thread  # noqa: F401

MODEL_RTOL = 1e-4
BLOCK_RTOL = 1e-5
SIZE, BATCH, LR = 64, 2, 0.1


def close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(getattr(want, "_value", want))
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _zero_create(self, shape, dtype=None, name=None):
    return JaxParameter(np.zeros(tuple(int(s) for s in shape), np.float32),
                        name=name)


def reference(factory, *args, **kw):
    """A reference model built with zero weights (see the docstring)."""
    saved = jinit.Initializer.create
    jinit.Initializer.create = _zero_create
    try:
        return factory(*args, **kw)
    finally:
        jinit.Initializer.create = saved


def draw(name, shape, rng):
    if len(shape) == 4:                                 # KaimingUniform
        limit = np.sqrt(6.0 / np.prod(shape[1:]))
        return ((rng.rand(*shape) * 2 - 1) * limit).astype(np.float32)
    if len(shape) == 2:                                 # XavierNormal
        return (rng.randn(*shape) * np.sqrt(2.0 / sum(shape))).astype(
            np.float32)
    if name.endswith("weight"):
        return (1 + 0.1 * rng.randn(*shape)).astype(np.float32)
    return (0.1 * rng.randn(*shape)).astype(np.float32)


def pair(jmodel, model, seed):
    """Seeded weights into ``jmodel`` and on into ``model`` (when given);
    returns the reference's (parameter names, buffer names, parameter
    values, buffer values)."""
    rng = np.random.RandomState(seed)
    tensors = jmodel.raw_state_tensors()
    pnames = [n for n, _ in jmodel.named_parameters()]
    bnames = [n for n, _ in jmodel.named_buffers()]
    pvals = [draw(n, tuple(tensors[n].shape), rng) for n in pnames]
    for n, v in zip(pnames, pvals):
        tensors[n]._value = jnp.asarray(v)
    bvals = [np.asarray(tensors[n]._value) for n in bnames]
    if model is not None:
        load_jax_state(model, pnames + bnames, pvals + bvals)
    return pnames, bnames, pvals, bvals


def port_resnet18(state, **kw):
    """A port ResNet-18 (10 classes, on the CPU) holding ``state``."""
    pnames, bnames, pvals, bvals = state
    model = models.resnet18(num_classes=10, device="cpu", **kw)
    load_jax_state(model, pnames + bnames, pvals + bvals)
    return model


def ref_forward(jmodel, names, values, x, labels=None, train=True):
    """The reference model's logits (and loss), and the buffers its
    forward leaves, traced through ``bind_state``."""
    bnames = [n for n, _ in jmodel.named_buffers()]
    jmodel.train() if train else jmodel.eval()
    with jmodel.bind_state(names, values):
        logits = jmodel(JaxTensor(x))._value
        tensors = jmodel.raw_state_tensors()
        buffers = [tensors[n]._value for n in bnames]
    loss = None if labels is None else jF.cross_entropy.raw_fn(logits, labels)
    return loss, (logits, buffers)


@pytest.fixture(scope="module")
def resnet18_pair():
    """The reference ResNet-18 (10 classes) and its seeded state."""
    jmodel = reference(jmodels.resnet18, num_classes=10)
    return jmodel, pair(jmodel, None, 0)


def _batch(seed, layout="NCHW"):
    rng = np.random.RandomState(seed)
    x = (rng.rand(BATCH, 3, SIZE, SIZE) * 2 - 1).astype(np.float32)
    if layout == "NHWC":
        x = np.ascontiguousarray(np.moveaxis(x, 1, -1))
    return x, rng.randint(0, 10, BATCH).astype(np.int64)


def test_resnet18_eval_logits(resnet18_pair):
    """Eval mode normalises with the running statistics (drawn here,
    variances positive) and leaves them as they are."""
    jmodel, state = resnet18_pair
    pnames, bnames, pvals, bvals = state
    rng = np.random.RandomState(9)
    bvals = [(rng.rand(*np.shape(b)) + 0.5 if n.endswith("_variance")
              else rng.randn(*np.shape(b)) * 0.1).astype(np.float32)
             for n, b in zip(bnames, bvals)]
    model = port_resnet18((pnames, bnames, pvals, bvals))
    model.eval()
    x, _ = _batch(1)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    logits, after = jax.jit(lambda v, x: ref_forward(
        jmodel, pnames + bnames, v, x, train=False)[1])(pvals + bvals, x)
    close(got, logits, MODEL_RTOL)
    for name, b, a in zip(bnames, bvals, after):
        np.testing.assert_array_equal(b, np.asarray(a))
        assert torch.equal(dict(model.named_buffers())[name],
                           torch.from_numpy(b))


def test_resnet18_two_momentum_steps(resnet18_pair):
    """Two ``Momentum(0.1, 0.9)`` steps on one batch through
    ``TrainStep``: the first forward's train-mode logits, each step's
    loss, the parameters after each step and the running statistics
    (updated once a step)."""
    jmodel, state = resnet18_pair
    pnames, bnames, pvals, bvals = state
    model = port_resnet18(state)
    jopt = paddle.optimizer.Momentum(learning_rate=LR, momentum=0.9,
                                     parameters=jmodel.parameters())
    names = pnames + bnames

    def loss_of(p, b, x, y):
        return ref_forward(jmodel, names, list(p) + list(b), x, y)

    grad_fn = jax.jit(jax.value_and_grad(loss_of, has_aux=True))
    apply = jax.jit(lambda p, g, s, step: jopt.functional_apply(
        p, g, s, step=step))
    state = jopt.functional_init(dict(zip(pnames, pvals)))
    opt = Momentum(learning_rate=LR, momentum=0.9,
                   parameters=model.parameters())
    step = TrainStep(model, F.cross_entropy, opt, device="cpu")
    x, y = _batch(2)
    p, b = [jnp.asarray(v) for v in pvals], [jnp.asarray(v) for v in bvals]
    for i in range(2):
        (jloss, (logits, b)), grads = grad_fn(p, b, x, y)
        if i == 0:
            # the train-mode logits, on a copy (its statistics move too)
            close(copy.deepcopy(model)(torch.from_numpy(x)), logits,
                  MODEL_RTOL)
        new, state = apply(dict(zip(pnames, p)), dict(zip(pnames, grads)),
                           state, i + 1)
        p = [new[n] for n in pnames]
        loss = step(torch.from_numpy(x), torch.from_numpy(y))
        close(loss, jloss, MODEL_RTOL)
        got = dict(zip(*export_state(model)))
        for name, want in zip(names, p + b):
            close(got[name], want, MODEL_RTOL)


def test_bottleneck_block_with_downsample():
    """ResNet-50's block alone (stride 2, a 1x1 downsample with its batch
    norm), in training: output, every gradient, the running statistics."""
    import paddle_tpu.nn as jnn
    from paddle_tpu_torch import nn

    def down(lib, **kw):
        return lib.Sequential(lib.Conv2D(16, 32, 1, stride=2,
                                         bias_attr=False, **kw),
                              lib.BatchNorm2D(32, **kw))

    jblock = reference(jmodels.resnet.BottleneckBlock, 16, 8, stride=2,
                       downsample=reference(down, jnn))
    block = models.BottleneckBlock(16, 8, stride=2, device="cpu",
                                   downsample=down(nn, device="cpu"))
    pnames, bnames, pvals, bvals = pair(jblock, block, 3)
    rng = np.random.RandomState(4)
    x = (rng.rand(2, 16, 8, 8) * 2 - 1).astype(np.float32)
    g = (rng.rand(2, 32, 4, 4) * 2 - 1).astype(np.float32)

    def run(p, x):
        """(output, the statistics it leaves): ``has_aux`` form."""
        with jblock.bind_state(pnames + bnames, list(p) + bvals):
            out = jblock(JaxTensor(x))._value
            tensors = jblock.raw_state_tensors()
            return out, [tensors[n]._value for n in bnames]

    def run_and_vjp(p, x, g):
        out, vjp, stats = jax.vjp(run, p, x, has_aux=True)
        return out, stats, vjp(g)

    want_out, want_stats, grads = jax.jit(run_and_vjp)(pvals, x, g)
    xt = torch.tensor(x, requires_grad=True)
    got = block(xt)
    close(got, want_out, BLOCK_RTOL)
    got.backward(torch.from_numpy(g))
    close(xt.grad, grads[1], BLOCK_RTOL)
    params = dict(block.named_parameters())
    assert list(params) == pnames
    for name, want in zip(pnames, grads[0]):
        close(params[name].grad, want, BLOCK_RTOL)
    buffers = dict(block.named_buffers())
    for name, want in zip(bnames, want_stats):
        close(buffers[name], want, BLOCK_RTOL)


@pytest.mark.parametrize("factory", [
    "resnet34", "resnet50", "resnet101", "resnext50_32x4d",
    "wide_resnet50_2"])
def test_reference_state_loads_by_name(factory):
    """A reference model's whole ``functional_state()`` (parameters, then
    the batch norms' ``_mean`` / ``_variance``) loads into the port's by
    name with every shape equal, and comes back out under the same names;
    an unknown or missing name, or a wrong shape, still raises."""
    jmodel = reference(getattr(jmodels, factory))
    model = getattr(models, factory)(device="cpu")
    names, values = jmodel.functional_state()
    values = [np.asarray(v) for v in values]
    bnames = [n for n, _ in jmodel.named_buffers()]
    assert bnames and all(n.endswith(("._mean", "._variance"))
                          for n in bnames)
    assert [n for n, _ in model.named_buffers()] == bnames
    values[-1] = values[-1] + 3.0                 # a non-default statistic
    load_jax_state(model, names, values)
    out_names, out_values = export_state(model)
    assert out_names == names
    np.testing.assert_array_equal(out_values[-1], values[-1])
    if factory != "resnet50":
        return
    assert "layer4.2.bn3._variance" in names
    assert "layer1.0.downsample.0.weight" in names
    with pytest.raises(ValueError, match="unknown"):
        load_jax_state(model, names[:-1] + ["bn1._running"], values)
    with pytest.raises(ValueError, match="missing"):
        load_jax_state(model, names[:-1], values[:-1])
    with pytest.raises(ValueError, match="shape"):
        load_jax_state(model, names, values[:-1] + [values[-1][:-1]])


def test_nhwc_pool_and_heads(resnet18_pair):
    """NHWC gives NCHW's logits on the same weights (the NCHW model is
    held to the reference above; ``test_torch_conv_pool_norm.py`` holds
    the channel-last layers to the reference's); ``with_pool=False``
    gives the last stage's maps and ``num_classes=0`` the pooled
    features."""
    _, state = resnet18_pair
    pnames, bnames, pvals, bvals = state
    x, _ = _batch(5)
    nhwc = port_resnet18(state, data_format="NHWC")
    xl = np.ascontiguousarray(np.moveaxis(x, 1, -1))
    got = nhwc(torch.from_numpy(xl))
    close(got, port_resnet18(state)(torch.from_numpy(x)).detach().numpy(),
          MODEL_RTOL)
    for kw, shape in ((dict(with_pool=False, num_classes=0),
                       (BATCH, 512, SIZE // 32, SIZE // 32)),
                      (dict(num_classes=0), (BATCH, 512, 1, 1))):
        head = models.resnet18(device="cpu", **kw)
        load_jax_state(head, pnames[:-2] + bnames, pvals[:-2] + bvals)
        feats = head(torch.from_numpy(x))
        assert tuple(feats.shape) == shape
    assert [n for n, _ in head.named_parameters()][-1] == \
        "layer4.1.bn2.bias"


def test_pretrained_raises_and_factories():
    with pytest.raises(NotImplementedError, match="download"):
        models.resnet50(pretrained=True, device="cpu")
    m = models.resnext101_64x4d(device="cpu", num_classes=0)
    assert (m.groups, m.base_width) == (64, 4)
    assert tuple(m.layer1[0].conv2.weight.shape) == (256, 4, 3, 3)
    assert models.wide_resnet101_2.__name__ == "wide_resnet101_2"
    m = models.resnet18(device="cpu", dtype=torch.bfloat16)
    assert m.bn1._mean.dtype == torch.bfloat16
    assert m.fc.weight.name == "fc.weight"


def test_model_benchmark_cpu_row(capsys):
    """The port's ``tools.model_benchmark resnet50`` on the CPU: the
    reference's plumbing row (batch 4, 32 x 32, 2 warm-up steps), one
    timed step a layout; the other rows raise."""
    from paddle_tpu_torch.tools import model_benchmark

    assert model_benchmark.main(["resnet50", "--device", "cpu",
                                 "--iters", "1"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["metric"] == "resnet50_train_images_per_sec_per_chip"
    assert (report["batch"], report["image_size"], report["warmup"]) == (
        4, 32, 2)
    assert set(report["per_layout_images_per_sec"]) == {"NHWC", "NCHW"}
    for row in report["per_layout"].values():
        assert len(row["losses"]) == 3 and len(row["step_ms_each"]) == 1
    assert report["value"] == max(report["per_layout_images_per_sec"]
                                  .values()) > 0
    with pytest.raises(NotImplementedError, match="not yet ported"):
        model_benchmark.main(["ernie_dp", "--device", "cpu"])
