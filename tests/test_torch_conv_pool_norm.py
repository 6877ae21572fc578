"""The port's convolutions, pooling and norms (functionals and layers)
against the JAX package's, on the same numpy inputs from a seed.

Each functional case runs forward and backward in both packages: the
port's autograd gradients against ``jax.vjp`` of the reference's raw
function on the same random cotangent. Tolerance: ``rtol = 1e-5`` of the
largest magnitude of the reference's array (float32 ops whose sums run
over at most a few hundred terms); integer outputs (max pooling's mask)
must be equal. Layers are built in both packages, the reference's
weights (and running statistics) carried across by
``models.convert.load_jax_state``, and compared the same way.

The cases cover every padding form (int, per-dim ints, ``2n`` lists,
pairs, ``SAME``, ``VALID``) in 1-D, 2-D and 3-D, channel-first and
channel-last, strides, dilations and groups; the transposed paths with
``output_padding`` and the string paddings; max, average (exclusive or
not) and adaptive pooling with padding beyond half the window; the
mirrored ``ceil_mode`` / ``divisor_override`` ("Faults of the reference"
8); batch norm in training (with its running statistics) and in eval.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.core.tensor import Parameter as JaxParameter
from paddle_tpu.nn import functional as jF
from paddle_tpu.nn import initializer as jinit
from paddle_tpu_torch import nn
from paddle_tpu_torch.models import export_state, load_jax_state
from paddle_tpu_torch.nn import functional as F
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-5
CHANNEL_LAST = {3: "NLC", 4: "NHWC", 5: "NDHWC"}


def _np(x):
    return np.asarray(getattr(x, "_value", x))


def close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(scale, 1e-6))


def _rand(rng, shape):
    return (rng.rand(*shape).astype(np.float32) - 0.5) * 2


def jax_value_and_vjp(jax_fn, arrays, g):
    """The reference's output and its VJP on ``g``, in one compiled call
    (op-by-op dispatch compiles every op on its own and is ~5x slower)."""
    def both(arrays, g):
        out, vjp = jax.vjp(jax_fn, *arrays)
        return out, vjp(g)
    return jax.jit(both)(arrays, g)


def jit_ref(fn, arrays, *args, **kw):
    """``fn(*arrays, *args, **kw)`` of the reference, compiled as one
    program."""
    return jax.jit(lambda *a: _raw(fn(*a, *args, **kw)))(*arrays)


def _raw(out):
    if isinstance(out, (tuple, list)):
        return type(out)(_raw(o) for o in out)
    return getattr(out, "_value", out)


def jit_layer(jlayer, *arrays):
    """A reference layer's forward on ``arrays``, traced through its
    ``functional_call`` and compiled as one program."""
    values = jlayer.functional_state()[1]
    return jax.jit(lambda v, *a: _raw(jlayer.functional_call(v, *a)))(
        values, *arrays)


def check_layout(layout, name, arrays, args, kw, seed):
    """``F.<name>(x, *rest, *args, **kw)``: channel-first against the
    reference (forward and gradients); channel-last, on the same input
    with its channels moved last, against the port's channel-first output
    and gradients, moved alike. The reference's channel-last forward is
    held separately (``test_channel_last_forward_matches_reference``)."""
    def port(*a, **extra):
        return getattr(F, name)(*a, *args, **kw, **extra)

    if layout == "first":
        check_vjp(port, lambda *a: getattr(jF, name).raw_fn(*a, *args, **kw),
                  arrays, seed)
        return
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    want = port(*ts)
    x = ts[0].detach().movedim(1, -1).contiguous().requires_grad_()
    got = port(x, *ts[1:], data_format=CHANNEL_LAST[x.dim()])
    g = torch.from_numpy(_rand(np.random.RandomState(seed), tuple(want.shape)))
    close(got.movedim(-1, 1), want.detach().numpy(), 1e-6)
    (want * g).sum().backward()
    (got * g.movedim(1, -1)).sum().backward()
    close(x.grad.movedim(-1, 1), ts[0].grad.numpy(), 1e-6)


def check_vjp(port_fn, jax_fn, arrays, seed=0, rtol=RTOL):
    """Forward and the gradient of every array in ``arrays``."""
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = port_fn(*ts)
    g = _rand(np.random.RandomState(seed + 100), tuple(out.shape))
    want, grads = jax_value_and_vjp(jax_fn, arrays, g)
    close(out, want, rtol)
    out.backward(torch.from_numpy(g))
    for t, w in zip(ts, grads):
        close(t.grad, w, rtol)


def _channel_last(shape):
    return (shape[0],) + tuple(shape[2:]) + (shape[1],)


# (dims, input shape NC..., weight shape, kwargs)
CONV_CASES = [
    (1, (2, 4, 11), (6, 4, 3), dict(padding=1)),
    (1, (2, 4, 11), (6, 2, 3), dict(padding="SAME", stride=2, groups=2)),
    (1, (2, 4, 11), (6, 4, 4), dict(padding=[2, 1], dilation=2)),
    (2, (2, 3, 9, 8), (4, 3, 3, 3), dict(padding=1, stride=2)),
    (2, (2, 3, 9, 8), (4, 3, 3, 2), dict(padding=[1, 0])),
    (2, (2, 4, 9, 8), (4, 2, 3, 3), dict(padding=[0, 2, 1, 1], groups=2)),
    (2, (2, 3, 9, 8), (4, 3, 3, 3), dict(padding=[(1, 2), (0, 1)],
                                         stride=(2, 1))),
    (2, (2, 3, 9, 8), (4, 3, 3, 3), dict(padding="SAME", stride=2,
                                         dilation=2)),
    (2, (2, 3, 9, 8), (4, 3, 2, 3), dict(padding="VALID", stride=3)),
    (3, (1, 2, 5, 6, 4), (3, 2, 3, 3, 2), dict(padding="SAME", stride=2)),
    (3, (1, 2, 5, 6, 4), (3, 2, 2, 3, 3), dict(padding=[1, 0, 1])),
]


@pytest.mark.parametrize("layout", ["first", "last"])
@pytest.mark.parametrize("case", range(len(CONV_CASES)))
def test_conv_matches_reference(case, layout):
    n, xs, ws, kw = CONV_CASES[case]
    rng = np.random.RandomState(case)
    x, w, b = _rand(rng, xs), _rand(rng, ws), _rand(rng, ws[:1])
    check_layout(layout, "conv%dd" % n, [x, w, b], (), kw, case)


# (dims, input shape, weight shape [in, out, k...], kwargs)
CONV_T_CASES = [
    (1, (2, 4, 7), (4, 3, 3), dict(stride=2, padding=1, output_padding=1)),
    (1, (2, 4, 7), (4, 3, 4), dict(padding="SAME", dilation=2)),
    (2, (2, 3, 5, 6), (3, 4, 3, 3), dict(stride=2, padding=[1, 0])),
    (2, (2, 3, 5, 6), (3, 4, 3, 2), dict(stride=(2, 3), padding=[0, 2, 1, 0],
                                         output_padding=(1, 2),
                                         dilation=(1, 2))),
    (2, (2, 3, 5, 6), (3, 4, 3, 3), dict(padding="VALID")),
    (2, (2, 3, 5, 6), (3, 4, 2, 3), dict(padding="SAME",
                                         output_padding=1)),
    (3, (1, 2, 3, 4, 3), (2, 3, 2, 3, 2), dict(stride=2, padding=1,
                                               output_padding=1)),
]


@pytest.mark.parametrize("layout", ["first", "last"])
@pytest.mark.parametrize("case", range(len(CONV_T_CASES)))
def test_conv_transpose_matches_reference(case, layout):
    n, xs, ws, kw = CONV_T_CASES[case]
    rng = np.random.RandomState(50 + case)
    x, w, b = _rand(rng, xs), _rand(rng, ws), _rand(rng, ws[1:2])
    check_layout(layout, "conv%dd_transpose" % n, [x, w, b], (), kw, case)


def test_grouped_conv_transpose_is_per_group_reference():
    """The reference's grouped transposed convolution raises (XLA wants
    the "IO" weight's I to be in / groups); the port's equals the
    reference run on each group alone."""
    rng = np.random.RandomState(3)
    x, w = _rand(rng, (2, 4, 5, 5)), _rand(rng, (4, 3, 3, 3))
    kw = dict(stride=2, padding=1, output_padding=1)
    got = F.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                             groups=2, **kw)
    want = np.concatenate([_np(jF.conv2d_transpose.raw_fn(
        x[:, 2 * g:2 * g + 2], w[2 * g:2 * g + 2], **kw)) for g in (0, 1)],
        axis=1)
    close(got, want)
    with pytest.raises(ValueError):
        jF.conv2d_transpose.raw_fn(x, w, groups=2, **kw)


def test_conv_transpose_string_padding_needs_stride_1():
    """XLA refuses a string padding with a dilated input, so the
    reference raises at stride 2, and so does the port."""
    rng = np.random.RandomState(4)
    x, w = _rand(rng, (1, 2, 5, 5)), _rand(rng, (2, 3, 3, 3))
    for padding in ("SAME", "VALID"):
        with pytest.raises(ValueError, match="stride"):
            F.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                               stride=2, padding=padding)
        with pytest.raises(ValueError):
            jF.conv2d_transpose.raw_fn(x, w, stride=2, padding=padding)


def test_deformable_conv_raises():
    with pytest.raises(NotImplementedError, match="A.10"):
        F.deformable_conv(None, None, None)


# (functional, input shape NC..., positional args, kwargs)
POOL_CASES = [
    ("max_pool1d", (2, 3, 11), (3,), dict(stride=2, padding=1)),
    ("max_pool1d", (2, 3, 11), (4,), dict(padding="SAME", stride=3)),
    ("max_pool2d", (2, 3, 9, 8), (3,), dict(stride=2, padding=1)),
    ("max_pool2d", (2, 3, 9, 8), ((3, 2),), dict(padding=[2, 0, 1, 1])),
    ("max_pool2d", (2, 3, 9, 8), (2,), dict(padding="SAME", stride=3)),
    ("max_pool3d", (1, 2, 5, 6, 4), (2,), dict(padding="VALID", stride=2)),
    ("max_pool3d", (1, 2, 5, 6, 4), (3,), dict(padding=[1, 2, 0], stride=2)),
    ("avg_pool1d", (2, 3, 11), (3,), dict(stride=2, padding=1)),
    ("avg_pool1d", (2, 3, 11), (3,), dict(padding=2, exclusive=False)),
    ("avg_pool2d", (2, 3, 9, 8), (3,), dict(stride=2, padding=1)),
    ("avg_pool2d", (2, 3, 9, 8), (3,), dict(padding=[2, 0, 1, 2])),
    ("avg_pool2d", (2, 3, 9, 8), ((2, 3),), dict(padding="SAME", stride=2,
                                                  exclusive=False)),
    ("avg_pool3d", (1, 2, 5, 6, 4), (2,), dict(padding=1, stride=2)),
    ("avg_pool3d", (1, 2, 5, 6, 4), (3,), dict(padding="SAME")),
    ("adaptive_avg_pool1d", (2, 3, 11), (4,), {}),
    ("adaptive_avg_pool2d", (2, 3, 9, 8), ((3, 4),), {}),
    ("adaptive_avg_pool2d", (2, 3, 9, 8), (1,), {}),
    ("adaptive_avg_pool3d", (1, 2, 5, 6, 4), ((2, 3, 3),), {}),
    ("adaptive_avg_pool3d", (1, 2, 6, 6, 4), ((3, 2, 2),), {}),
    ("adaptive_max_pool1d", (2, 3, 11), (3,), {}),
    ("adaptive_max_pool2d", (2, 3, 9, 8), ((4, 3),), {}),
    ("adaptive_max_pool3d", (1, 2, 5, 6, 4), ((2, 4, 3),), {}),
]


# the reference's adaptive 1-D poolings and adaptive_max_pool2d take no
# data_format
NO_LAYOUT = ("adaptive_avg_pool1d", "adaptive_max_pool1d",
             "adaptive_max_pool2d")


@pytest.mark.parametrize("case,layout", [
    (i, layout) for i, c in enumerate(POOL_CASES)
    for layout in ("first", "last")
    if layout == "first" or c[0] not in NO_LAYOUT])
def test_pool_matches_reference(case, layout):
    name, xs, args, kw = POOL_CASES[case]
    x = _rand(np.random.RandomState(200 + case), xs)
    check_layout(layout, name, [x], args, kw, case)


# one case of each family, channel-last, forward against the reference
LAST_CASES = [("conv2d", 0), ("conv3d_transpose", 1), ("max_pool2d", 2),
              ("avg_pool3d", 3), ("adaptive_avg_pool2d", 4),
              ("max_pool1d", 5)]


@pytest.mark.parametrize("name,seed", LAST_CASES)
def test_channel_last_forward_matches_reference(name, seed):
    rng = np.random.RandomState(300 + seed)
    kw = dict(data_format=CHANNEL_LAST[4])
    if name == "conv2d":
        arrays, args = [_rand(rng, (2, 6, 7, 3)), _rand(rng, (4, 3, 3, 3))], ()
        kw.update(padding=[1, 0, 2, 1], stride=2)
    elif name == "conv3d_transpose":
        arrays = [_rand(rng, (1, 3, 4, 3, 2)), _rand(rng, (2, 3, 2, 2, 3))]
        args = ()
        kw = dict(data_format="NDHWC", stride=2, padding=1, output_padding=1)
    elif name == "avg_pool3d":
        arrays, args = [_rand(rng, (1, 5, 6, 4, 2))], (3,)
        kw = dict(data_format="NDHWC", padding="SAME", stride=2)
    elif name == "max_pool1d":
        arrays, args = [_rand(rng, (2, 9, 3))], (3,)
        kw = dict(data_format="NLC", padding=2, stride=2)
    else:
        arrays, args = [_rand(rng, (2, 9, 8, 3))], ((3, 2),)
        if name == "max_pool2d":
            kw.update(padding=[2, 0, 1, 1])
    got = getattr(F, name)(*map(torch.from_numpy, arrays), *args, **kw)
    close(got, jit_ref(getattr(jF, name).raw_fn, arrays, *args, **kw))


@pytest.mark.parametrize("name", ["max_pool2d", "avg_pool2d", "avg_pool3d"])
def test_ceil_mode_and_divisor_override_are_mirrored(name):
    """The reference accepts both and reads neither: the output has the
    floor-mode size and an average divides as ``exclusive`` says."""
    rng = np.random.RandomState(7)
    x = _rand(rng, (1, 2, 8, 8) if name.endswith("2d") else (1, 2, 5, 8, 8))
    kw = dict(stride=2, padding=1, ceil_mode=True)
    if name.startswith("avg"):
        kw["divisor_override"] = 3
    got = getattr(F, name)(torch.from_numpy(x), 3, **kw)
    want = getattr(jF, name).raw_fn(x, 3, **kw)
    close(got, want)
    plain = getattr(F, name)(torch.from_numpy(x), 3, stride=2, padding=1)
    assert torch.equal(got, plain)
    # floor((8 + 2 - 3) / 2) + 1 = 4 rows; ceil mode would give 5
    assert got.shape[-1] == 4


@pytest.mark.parametrize("padding,layout", [
    (0, "NCHW"), (1, "NHWC"), ("SAME", "NCHW"), ([1, 0, 2, 1], "NHWC")])
def test_max_pool2d_mask_and_unpool(padding, layout):
    rng = np.random.RandomState(11)
    x = _rand(rng, (2, 3, 9, 8))
    if layout == "NHWC":
        x = np.ascontiguousarray(np.moveaxis(x, 1, -1))
    kw = dict(stride=2, padding=padding, return_mask=True,
              data_format=layout)
    out, mask = F.max_pool2d(torch.from_numpy(x), 3, **kw)
    jout, jmask = jit_ref(jF.max_pool2d.raw_fn, [x], 3, **kw)
    close(out, jout)
    np.testing.assert_array_equal(mask.numpy(), _np(jmask))
    assert mask.dtype == torch.int32
    un_kw = dict(stride=2, padding=padding, data_format=layout)
    for size in ({}, dict(output_size=(2, 3, 10, 9))):
        close(F.max_unpool2d(out, mask, 3, **un_kw, **size),
              jit_ref(jF.max_unpool2d.raw_fn, [jout, jmask], 3, **un_kw,
                      **size))


@pytest.mark.parametrize("dims", [1, 3])
def test_max_unpool_scatter_adds(dims):
    """Repeated indices add, as the reference's ``.at[...].add`` does."""
    rng = np.random.RandomState(12 + dims)
    xs = (2, 3, 4) if dims == 1 else (1, 2, 2, 3, 2)
    x = _rand(rng, xs)
    spatial = [(s - 1) * 2 - 2 + 3 for s in xs[2:]]
    idx = rng.randint(0, int(np.prod(spatial)), xs).astype(np.int32)
    name = "max_unpool%dd" % dims
    check_vjp(lambda t: getattr(F, name)(t, torch.from_numpy(idx), 3,
                                         stride=2, padding=1),
              lambda a: getattr(jF, name).raw_fn(a, idx, 3, stride=2,
                                                 padding=1), [x], dims)
    got = getattr(F, name)(torch.from_numpy(x), torch.from_numpy(idx), 3,
                           stride=2, padding=1, output_size=list(
                               (s + 1 for s in spatial)))
    assert tuple(got.shape[2:]) == tuple(s + 1 for s in spatial)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_batch_norm_functionals(layout):
    rng = np.random.RandomState(20)
    x = _rand(rng, (4, 3, 5, 6)) * 3 + 1
    if layout == "NHWC":
        x = np.ascontiguousarray(np.moveaxis(x, 1, -1))
    w, b = _rand(rng, (3,)), _rand(rng, (3,))
    mean, var = _rand(rng, (3,)), rng.rand(3).astype(np.float32) + 0.5

    def port_train(*a):
        out, m, v = F.batch_norm_train(*a, epsilon=1e-5, data_format=layout)
        return out + 0.5 * m.sum() + 0.25 * v.sum()

    def jax_train(*a):
        out, m, v = jF.batch_norm_train.raw_fn(*a, epsilon=1e-5,
                                               data_format=layout)
        return out + 0.5 * m.sum() + 0.25 * v.sum()

    check_vjp(port_train, jax_train, [x, w, b])
    _, m, v = F.batch_norm_train(torch.from_numpy(x), data_format=layout)
    _, jm, jv = jF.batch_norm_train.raw_fn(x, data_format=layout)
    close(m, jm)
    close(v, jv)                       # the biased variance
    check_vjp(lambda *a: F.batch_norm_infer(*a, data_format=layout),
              lambda *a: jF.batch_norm_infer.raw_fn(*a, data_format=layout),
              [x, mean, var, w, b])


NORM_CASES = [
    ("group_norm", (2, 6, 4, 5), (3,), dict(data_format="NCHW")),
    ("group_norm", (2, 4, 5, 6), (2,), dict(data_format="NHWC")),
    ("group_norm", (2, 6, 7), (3,), dict(data_format="NCL")),
    ("instance_norm", (2, 3, 4, 5), (), dict(data_format="NCHW")),
    ("instance_norm", (2, 4, 5, 3), (), dict(data_format="NHWC")),
    ("local_response_norm", (2, 7, 3, 4), (5,), dict(alpha=0.1, k=2.0)),
    ("local_response_norm", (2, 3, 4, 6), (4,), dict(data_format="NHWC",
                                                     beta=0.5)),
]


@pytest.mark.parametrize("case", range(len(NORM_CASES)))
def test_norm_functionals_match_reference(case):
    name, xs, args, kw = NORM_CASES[case]
    rng = np.random.RandomState(30 + case)
    x = _rand(rng, xs) * 2 + 0.5
    c = xs[-1] if kw.get("data_format", "NC").startswith("N") and \
        not kw.get("data_format", "NC").startswith("NC") else xs[1]
    arrays = [x]
    if name != "local_response_norm":
        arrays += [_rand(rng, (c,)), _rand(rng, (c,))]
    check_vjp(lambda *a: getattr(F, name)(a[0], *args, *a[1:], **kw),
              lambda *a: getattr(jF, name).raw_fn(a[0], *args, *a[1:], **kw),
              arrays, case)


def _jt(x):
    return paddle.to_tensor(x)


@pytest.fixture(autouse=True)
def zero_init(monkeypatch):
    """The reference builds its layers with zero weights here: its JAX
    initialisers compile once per shape, seconds a layer on the CPU. The
    tests draw the weights with numpy (``seed_state``) instead."""
    def create(self, shape, dtype=None, name=None):
        return JaxParameter(np.zeros(tuple(int(s) for s in shape),
                                     np.float32), name=name)
    monkeypatch.setattr(jinit.Initializer, "create", create)


def seed_state(jlayer, layer, seed):
    """Parameters drawn from ``seed`` (batch and group norm scales around
    1), the reference's buffers kept, set into the reference layer and
    carried into the port's by ``load_jax_state``; returns the names."""
    rng = np.random.RandomState(seed)
    tensors = jlayer.raw_state_tensors()
    names, values = jlayer.functional_state()
    params = {n for n, _ in jlayer.named_parameters()}
    for name, v in zip(names, values):
        if name in params:
            v = _rand(rng, np.shape(v))
            if name.endswith("weight") and np.ndim(v) == 1:
                v = v * 0.25 + 1.0
            tensors[name]._value = jax.numpy.asarray(v)
    names, values = jlayer.functional_state()
    load_jax_state(layer, names, [np.asarray(v) for v in values])
    return names


def _layer_pair(jcls, cls, jargs, seed=0, **kw):
    jlayer = jcls(*jargs, **kw)
    layer = cls(*jargs, device="cpu", **kw)
    seed_state(jlayer, layer, seed)
    return jlayer, layer


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_batch_norm_layer_train_and_eval(layout):
    """Two training forwards move the running statistics by the
    reference's rule (old * 0.9 + batch * 0.1, biased variance); eval and
    ``use_global_stats`` normalise with them."""
    jbn, bn = _layer_pair(jnn.BatchNorm2D, nn.BatchNorm2D, (3,),
                          data_format=layout)
    assert sorted(n for n, _ in bn.named_buffers()) == ["_mean", "_variance"]
    rng = np.random.RandomState(40)
    for step in range(2):
        x = _rand(rng, (4, 3, 5, 6) if layout == "NCHW" else (4, 5, 6, 3))
        x = x * (step + 2) + 1
        close(bn(torch.from_numpy(x)), jbn(_jt(x)))
        close(bn._mean, jbn._mean)
        close(bn._variance, jbn._variance)
    bn.eval()
    jbn.eval()
    close(bn(torch.from_numpy(x)), jbn(_jt(x)))
    close(bn._mean, jbn._mean)
    jglob, glob = _layer_pair(jnn.BatchNorm2D, nn.BatchNorm2D, (3,),
                              data_format=layout, use_global_stats=True)
    before = glob._mean.clone()
    close(glob(torch.from_numpy(x)), jglob(_jt(x)))
    assert torch.equal(glob._mean, before)


def jit_train(jlayer, x):
    """A reference layer's training forward on ``x`` compiled as one
    program: its output and the buffers it leaves."""
    names, values = jlayer.functional_state()
    bnames = [n for n, _ in jlayer.named_buffers()]

    def run(v, x):
        with jlayer.bind_state(names, v):
            out = _raw(jlayer(x))
            tensors = jlayer.raw_state_tensors()
            return out, [tensors[n]._value for n in bnames]

    return jax.jit(run)(values, x)


def test_batch_norm_1d_3d_and_legacy_act():
    rng = np.random.RandomState(41)
    for jcls, cls, xs in ((jnn.BatchNorm1D, nn.BatchNorm1D, (6, 4)),
                          (jnn.BatchNorm3D, nn.BatchNorm3D, (2, 4, 3, 2, 3))):
        jbn, bn = _layer_pair(jcls, cls, (4,), momentum=0.8, epsilon=1e-3)
        x = _rand(rng, xs)
        want, (mean, var) = jit_train(jbn, x)
        close(bn(torch.from_numpy(x)), want)
        close(bn._mean, mean)
        close(bn._variance, var)
    jbn, bn = _layer_pair(jnn.BatchNorm, nn.BatchNorm, (4,), act="relu")
    x = _rand(rng, (3, 4, 2, 2))
    out = bn(torch.from_numpy(x)).detach()
    close(out, jit_train(jbn, x)[0])
    assert float(out.min()) == 0.0


def test_batch_norm_without_affine_and_to_bf16():
    bn = nn.BatchNorm2D(3, weight_attr=False, bias_attr=False, device="cpu")
    assert bn.weight is None and bn.bias is None
    x = torch.randn(4, 3, 2, 2, generator=torch.Generator().manual_seed(0))
    out = bn(x)
    close(out, jF.batch_norm_train.raw_fn(x.numpy())[0])
    # Layer.to(dtype) casts the running statistics with the parameters
    conv = nn.Sequential(nn.Conv2D(3, 3, 1, device="cpu"),
                         nn.BatchNorm2D(3, device="cpu"))
    conv.to(torch.bfloat16)
    assert conv[1]._mean.dtype == torch.bfloat16
    assert conv[1].weight.dtype == torch.bfloat16
    assert conv(x.to(torch.bfloat16)).dtype == torch.bfloat16


def test_convert_sync_batchnorm():
    jmodel = jnn.Sequential(jnn.Conv2D(3, 4, 3), jnn.BatchNorm2D(4))
    model = nn.Sequential(nn.Conv2D(3, 4, 3, device="cpu"),
                          nn.BatchNorm2D(4, device="cpu"))
    names = seed_state(jmodel, model, 1)
    x = _rand(np.random.RandomState(2), (2, 3, 6, 6))
    model(torch.from_numpy(x))                  # moves the statistics
    jmodel(_jt(x))
    synced = nn.SyncBatchNorm.convert_sync_batchnorm(model)
    jsynced = jnn.SyncBatchNorm.convert_sync_batchnorm(jmodel)
    assert isinstance(synced[1], nn.SyncBatchNorm)
    assert export_state(synced)[0] == names
    close(synced[1]._mean, jsynced[1]._mean)
    close(synced(torch.from_numpy(x)), jsynced(_jt(x)))


# (reference class, port class, constructor args, input shape, kwargs)
LAYER_CASES = [
    ("Conv1D", (3, 4, 3), (2, 3, 9), dict(padding=1)),
    ("Conv2D", (3, 4, 3), (2, 3, 7, 6), dict(stride=2, padding="SAME")),
    ("Conv2D", (4, 6, 3), (2, 5, 6, 4), dict(groups=2, bias_attr=False,
                                             data_format="NHWC")),
    ("Conv3D", (2, 3, 2), (1, 2, 4, 5, 3), dict(padding=[1, 0, 1])),
    ("Conv1DTranspose", (3, 2, 3), (2, 3, 5), dict(stride=2,
                                                   output_padding=1)),
    ("Conv2DTranspose", (3, 2, 3), (2, 3, 4, 5), dict(stride=2, padding=1)),
    ("Conv3DTranspose", (2, 3, 2), (1, 2, 3, 3, 2), dict(stride=2)),
    ("GroupNorm", (2, 4), (2, 4, 3, 3), {}),
    ("InstanceNorm1D", (3,), (2, 3, 5), {}),
    ("InstanceNorm2D", (3,), (2, 3, 4, 5), {}),
    ("InstanceNorm3D", (3,), (2, 3, 2, 3, 2), {}),
    ("LocalResponseNorm", (3,), (2, 5, 3, 3), {}),
    ("MaxPool1D", (3,), (2, 3, 9), dict(stride=2, padding=1)),
    ("MaxPool2D", (3,), (2, 3, 7, 6), dict(stride=2, padding=1,
                                           data_format="NHWC")),
    ("MaxPool3D", (2,), (1, 2, 4, 5, 4), {}),
    ("AvgPool1D", (3,), (2, 3, 9), dict(padding=1, exclusive=False)),
    ("AvgPool2D", (3,), (2, 3, 7, 6), dict(stride=2, padding=1)),
    ("AvgPool3D", (2,), (1, 2, 4, 5, 4), dict(padding=1)),
    ("AdaptiveAvgPool1D", (4,), (2, 3, 9), {}),
    ("AdaptiveAvgPool2D", ((1, 1),), (2, 3, 7, 6), {}),
    ("AdaptiveAvgPool3D", (2,), (1, 2, 4, 5, 4), {}),
    ("AdaptiveMaxPool1D", (4,), (2, 3, 9), {}),
    ("AdaptiveMaxPool2D", (3,), (2, 3, 7, 6), {}),
    ("AdaptiveMaxPool3D", (2,), (1, 2, 4, 5, 4), {}),
]


@pytest.mark.parametrize("case", range(len(LAYER_CASES)),
                         ids=[c[0] + "-%d" % i
                              for i, c in enumerate(LAYER_CASES)])
def test_layers_match_reference(case):
    name, args, xs, kw = LAYER_CASES[case]
    rng = np.random.RandomState(60 + case)
    x = _rand(rng, xs)
    jlayer = getattr(jnn, name)(*args, **kw)
    try:
        layer = getattr(nn, name)(*args, device="cpu", **kw)
    except TypeError:                  # layers without parameters
        layer = getattr(nn, name)(*args, **kw)
    assert [n for n, _ in layer.named_parameters()] == \
        [n for n, _ in jlayer.named_parameters()]
    seed_state(jlayer, layer, case)
    xt = torch.tensor(x, requires_grad=True)
    out = layer(xt)
    close(out, jit_layer(jlayer, x))
    out.square().sum().backward()
    assert torch.isfinite(xt.grad).all()


def test_max_unpool_layers():
    rng = np.random.RandomState(70)
    x = _rand(rng, (2, 3, 6, 6))
    out, mask = F.max_pool2d(torch.from_numpy(x), 2, return_mask=True)
    close(nn.MaxUnPool2D(2)(out, mask),
          jit_layer(jnn.MaxUnPool2D(2), out.numpy(), mask.numpy()))
    idx = np.array([[[0, 3, 3]]], np.int32)
    v = _rand(rng, (1, 1, 3))
    close(nn.MaxUnPool1D(2)(torch.from_numpy(v), torch.from_numpy(idx)),
          jit_layer(jnn.MaxUnPool1D(2), v, idx))
    idx3 = np.array([[[[[0, 7]]]]], np.int32)
    v3 = _rand(rng, (1, 1, 1, 1, 2))
    close(nn.MaxUnPool3D(2)(torch.from_numpy(v3), torch.from_numpy(idx3)),
          jit_layer(jnn.MaxUnPool3D(2), v3, idx3))


def test_spectral_norm_matches_reference():
    rng = np.random.RandomState(71)
    w = _rand(rng, (4, 3, 2))
    got = nn.SpectralNorm((4, 3, 2), axis=1, power_iters=3)(
        torch.from_numpy(w))
    close(got, jit_layer(jnn.SpectralNorm((4, 3, 2), axis=1,
                                          power_iters=3), w))


def test_conv_layer_initialisers():
    """KaimingUniform weights within sqrt(6 / fan_in), the bias within
    1 / sqrt(fan_in), drawn from the generator."""
    gen = torch.Generator().manual_seed(5)
    conv = nn.Conv2D(8, 16, 3, groups=2, generator=gen, device="cpu")
    fan_in = 4 * 9
    assert float(conv.weight.abs().max()) <= (6 / fan_in) ** 0.5
    assert float(conv.weight.abs().max()) > 0.9 * (6 / fan_in) ** 0.5
    assert float(conv.bias.abs().max()) <= fan_in ** -0.5
    again = nn.Conv2D(8, 16, 3, groups=2, device="cpu",
                      generator=torch.Generator().manual_seed(5))
    assert torch.equal(conv.weight, again.weight)
    assert nn.Conv2D(3, 4, 1, bias_attr=False, device="cpu").bias is None


# -- one value per channel (C.1) and convert_sync_batchnorm (C.2) ----------

def ref_train_vjp(jlayer, x, g):
    """A reference layer's training forward on ``x`` compiled as one
    program: its output, the buffers it leaves, and the VJP of ``g`` for
    its parameters and ``x``."""
    names, values = jlayer.functional_state()
    bnames = [n for n, _ in jlayer.named_buffers()]

    def run(v, x):
        with jlayer.bind_state(names, v):
            out = _raw(jlayer(x))
            tensors = jlayer.raw_state_tensors()
            return out, [tensors[n]._value for n in bnames]

    def both(v, x, g):
        out, vjp, buffers = jax.vjp(run, v, x, has_aux=True)
        return out, buffers, vjp(g)

    return names, jax.jit(both)(values, x, g)


# (reference class, constructor args, input shape, kwargs): each channel,
# or each instance's channel, holds one value
ONE_VALUE_CASES = [
    ("BatchNorm1D", (4,), (1, 4), {}),
    ("BatchNorm2D", (4,), (1, 4, 1, 1), {}),
    ("BatchNorm2D", (4,), (1, 1, 1, 4), dict(data_format="NHWC")),
    ("BatchNorm3D", (3,), (1, 3, 1, 1, 1), dict(momentum=0.8)),
    ("InstanceNorm1D", (4,), (1, 4, 1), {}),
    ("InstanceNorm2D", (3,), (2, 3, 1, 1), {}),
]


@pytest.mark.parametrize("case", range(len(ONE_VALUE_CASES)),
                         ids=[c[0] + "-%d" % i
                              for i, c in enumerate(ONE_VALUE_CASES)])
def test_one_value_per_channel_matches_reference(case):
    """The output (``bias``), every gradient (0 but the bias's) and the
    running statistics (the mean moves to ``x`` by ``1 - momentum``, the
    variance decays by ``momentum``), where torch's fused passes raise."""
    name, args, xs, kw = ONE_VALUE_CASES[case]
    jlayer, layer = _layer_pair(getattr(jnn, name), getattr(nn, name), args,
                                seed=80 + case, **kw)
    rng = np.random.RandomState(90 + case)
    x = _rand(rng, xs) * 3
    g = _rand(rng, xs)
    names, (want, buffers, (gv, gx)) = ref_train_vjp(jlayer, x, g)
    xt = torch.tensor(x, requires_grad=True)
    out = layer(xt)
    close(out, want)
    out.backward(torch.from_numpy(g))
    close(xt.grad, gx)
    params = dict(layer.named_parameters())
    for n, v in zip(names, gv):
        if n in params:
            close(params[n].grad, v)
    for (n, b), v in zip(layer.named_buffers(), buffers):
        close(b, v)
    if name.startswith("BatchNorm"):
        m = kw.get("momentum", 0.9)
        assert torch.equal(layer._variance,
                           torch.full_like(layer._variance, m))


def test_one_value_functionals_match_reference():
    rng = np.random.RandomState(96)
    x = _rand(rng, (2, 3, 1, 1)) * 3
    w, b = _rand(rng, (3,)), _rand(rng, (3,))
    check_vjp(F.instance_norm, jF.instance_norm.raw_fn, [x, w, b])

    def port_train(*a):
        out, m, v = F.batch_norm_train(*a)
        return out + 0.5 * m.sum() + 0.25 * v.sum()

    def jax_train(*a):
        out, m, v = jF.batch_norm_train.raw_fn(*a)
        return out + 0.5 * m.sum() + 0.25 * v.sum()

    check_vjp(port_train, jax_train, [x[:1, :, :, 0], w, b])


def test_resnet18_trains_at_batch_1_and_32():
    """ResNet-18 in training at batch 1, 32 x 32: layer4 normalises 1 x 1
    maps, one value a channel. The logits, the loss's gradient of every
    parameter and every running statistic against the reference's."""
    from test_torch_resnet import pair, ref_forward

    from paddle_tpu.vision import models as jmodels
    from paddle_tpu_torch.vision import models

    jmodel = jmodels.resnet18(num_classes=10)
    model = models.resnet18(num_classes=10, device="cpu")
    pnames, bnames, pvals, bvals = pair(jmodel, model, 97)
    rng = np.random.RandomState(98)
    x = _rand(rng, (1, 3, 32, 32))
    y = np.array([3])

    def loss_of(p, b):
        return ref_forward(jmodel, pnames + bnames, list(p) + list(b), x, y)

    (jloss, (logits, after)), grads = jax.jit(jax.value_and_grad(
        loss_of, has_aux=True))(pvals, bvals)
    out = model(torch.from_numpy(x))
    close(out, logits)
    loss = F.cross_entropy(out, torch.from_numpy(y))
    close(loss, jloss)
    loss.backward()
    params = dict(model.named_parameters())
    for n, gw in zip(pnames, grads):
        close(params[n].grad, gw)
    got = dict(model.named_buffers())
    for n, v in zip(bnames, after):
        close(got[n], v)
    assert torch.equal(got["layer4.1.bn2._variance"],
                       torch.full((512,), 0.9))


@pytest.mark.parametrize("kw", [dict(use_global_stats=True),
                                dict(weight_attr=False),
                                dict(bias_attr=False)])
def test_convert_sync_batchnorm_refuses_what_the_reference_drops(kw):
    """The reference's conversion drops ``use_global_stats`` and gives a
    layer without ``weight`` / ``bias`` ones and zeros ("Faults of the
    reference" 11); the port raises instead. A default-built layer
    converts (``test_convert_sync_batchnorm``)."""
    jsync = jnn.SyncBatchNorm.convert_sync_batchnorm(jnn.BatchNorm2D(3, **kw))
    assert not jsync.use_global_stats
    assert jsync.weight is not None and jsync.bias is not None
    model = nn.Sequential(nn.Conv2D(3, 3, 1, device="cpu"),
                          nn.BatchNorm2D(3, device="cpu", **kw))
    with pytest.raises(NotImplementedError,
                       match="Faults of the reference' 11"):
        nn.SyncBatchNorm.convert_sync_batchnorm(model)
