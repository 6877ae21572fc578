"""The port's activations (functionals and layers) and containers against
the JAX package's, on the same inputs.

Inputs are float32 numpy arrays from a seed, spread over [-8, 8] so every
branch of the piecewise functions (thresholds at 0.5, 1, 3, 6, 20) is hit;
both packages compute them elementwise in float32, so the tolerance is
the other port tests' rtol 1e-4 / atol 1e-5 (XLA's CPU transcendentals
are approximate to ~1e-5 relative). The containers must give the
reference's parameter names, so that ``load_jax_state`` carries weights
across, and the same outputs on those weights.
"""
import collections

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.nn import functional as jax_F
from paddle_tpu_torch import nn
from paddle_tpu_torch.models import load_jax_state
from paddle_tpu_torch.nn import functional as F

TOL = dict(rtol=1e-4, atol=1e-5)


def _x(seed=0, shape=(3, 4, 6)):
    rng = np.random.RandomState(seed)
    return (rng.rand(*shape).astype(np.float32) - 0.5) * 16


def _np(x):
    return np.asarray(getattr(x, "_value", x))


# (name, extra positional/keyword arguments shared by both packages)
FUNCTIONALS = [
    ("relu", {}), ("relu6", {}), ("gelu", {}), ("gelu", dict(approximate=True)),
    ("sigmoid", {}), ("tanh", {}), ("silu", {}), ("swish", {}), ("mish", {}),
    ("elu", dict(alpha=0.7)), ("selu", {}), ("celu", dict(alpha=1.5)),
    ("leaky_relu", dict(negative_slope=0.2)), ("rrelu", {}),
    ("hardtanh", dict(min=-2.0, max=3.0)), ("hardsigmoid", {}),
    ("hardswish", {}), ("hardshrink", dict(threshold=1.0)),
    ("softshrink", dict(threshold=0.7)), ("tanhshrink", {}),
    ("softplus", dict(beta=2.0, threshold=10.0)), ("softsign", {}),
    ("softmax", dict(axis=1)), ("log_softmax", {}), ("glu", dict(axis=-1)),
    ("maxout", dict(groups=2, axis=1)), ("thresholded_relu", {}),
    ("log_sigmoid", {}),
]


@pytest.mark.parametrize("case", range(len(FUNCTIONALS)),
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(FUNCTIONALS)])
def test_functional_matches_reference(case):
    name, kw = FUNCTIONALS[case]
    x = _x(case)
    got = getattr(F, name)(torch.from_numpy(x), **kw)
    want = _np(getattr(jax_F, name)(x, **kw))
    assert got.dtype == getattr(torch, str(want.dtype))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("name", ["softmax", "log_softmax"])
def test_softmax_dtype_casts_first(name):
    x = _x(7)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = getattr(F, name)(xb, axis=-1, dtype="float32")
    assert got.dtype == torch.float32
    want = _np(getattr(jax_F, name)(paddle.to_tensor(x).astype("bfloat16"),
                                    axis=-1, dtype="float32"))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_prelu_matches_reference(data_format):
    x = _x(1, (2, 4, 3, 4))
    w = np.array([0.1, -0.2, 0.3, 0.25], np.float32)
    got = F.prelu(torch.from_numpy(x), torch.from_numpy(w), data_format)
    np.testing.assert_allclose(
        got.numpy(), _np(jax_F.prelu(x, w, data_format)), **TOL)


@pytest.mark.parametrize("name", ["relu_", "elu_", "tanh_", "softmax_"])
def test_inplace_spellings_write_their_input(name):
    x = torch.from_numpy(_x(2))
    want = getattr(F, name[:-1])(x.clone())
    out = getattr(F, name)(x)
    assert out is x
    np.testing.assert_array_equal(x.numpy(), want.numpy())


@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_softmax_is_a_distribution_from_its_generator(hard):
    x = torch.from_numpy(_x(3))
    draw = [F.gumbel_softmax(x, temperature=0.5, hard=hard,
                             generator=torch.Generator().manual_seed(7))
            for _ in range(2)]
    assert torch.equal(draw[0], draw[1])
    np.testing.assert_allclose(draw[0].sum(-1).numpy(), 1.0, rtol=1e-5)
    if hard:
        # one-hot up to the straight-through sum's rounding (y - y)
        hot = draw[0].numpy()
        np.testing.assert_allclose(hot, np.round(hot), atol=1e-6)
        assert (np.round(hot).sum(-1) == 1).all()
        xg = x.clone().requires_grad_()
        F.gumbel_softmax(xg, hard=True)[..., 0].sum().backward()
        assert xg.grad.abs().sum() > 0   # the soft values' gradient


def test_every_reference_activation_has_a_port_counterpart():
    import paddle_tpu.nn.functional.activation as jact
    names = [n for n, v in vars(jact).items()
             if callable(v) and not n.startswith("_")
             and getattr(v, "__module__", "").endswith("activation")]
    names += ["relu_", "elu_", "tanh_", "softmax_"]
    missing = [n for n in names if not hasattr(F, n)]
    assert not missing, missing


# (class name, constructor arguments shared by both packages)
LAYERS = [
    ("ReLU", {}), ("ReLU6", {}), ("GELU", dict(approximate=True)),
    ("Sigmoid", {}), ("Tanh", {}), ("Silu", {}), ("Swish", {}), ("Mish", {}),
    ("ELU", dict(alpha=0.5)), ("SELU", {}), ("CELU", dict(alpha=2.0)),
    ("LeakyReLU", dict(negative_slope=0.1)), ("Hardtanh", {}),
    ("Hardsigmoid", {}), ("Hardswish", {}), ("Hardshrink", {}),
    ("Softshrink", {}), ("Tanhshrink", {}), ("Softplus", dict(beta=0.5)),
    ("Softsign", {}), ("Softmax", dict(axis=1)), ("LogSoftmax", {}),
    ("LogSigmoid", {}), ("Maxout", dict(groups=3, axis=-1)),
    ("ThresholdedReLU", dict(threshold=0.5)), ("RReLU", {}),
    ("Softmax2D", {}),
]


@pytest.mark.parametrize("name", [c[0] for c in LAYERS])
def test_layer_matches_reference(name):
    kw = dict(LAYERS)[name]
    x = _x(4)
    layer = getattr(nn, name)(**kw)
    got = layer(torch.from_numpy(x))
    want = _np(getattr(jnn, name)(**kw)(paddle.to_tensor(x)))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_prelu_layer_matches_reference():
    paddle.seed(0)
    jlayer = jnn.PReLU(num_parameters=4, init=0.3)
    layer = nn.PReLU(num_parameters=4, init=0.3, device="cpu")
    names, values = jlayer.functional_state()
    assert names == [n for n, _ in layer.named_parameters()] == ["weight"]
    x = _x(5, (2, 4, 5))
    np.testing.assert_allclose(
        layer(torch.from_numpy(x)).detach().numpy(),
        _np(jlayer(paddle.to_tensor(x))), **TOL)


# -- containers ---------------------------------------------------------------

def _linear_pair(i, o):
    return jnn.Linear(i, o), nn.Linear(i, o, generator=torch.Generator(),
                                       device="cpu")


def _build(kind):
    """The same container in both packages, over fresh Linear layers."""
    paddle.seed(1)
    pairs = [_linear_pair(6, 6) for _ in range(3)]
    js, ts = [p[0] for p in pairs], [p[1] for p in pairs]
    if kind == "sequential":
        return jnn.Sequential(*js), nn.Sequential(*ts)
    if kind == "sequential_named":
        names = ("fc_a", "fc_b", "fc_c")
        return (jnn.Sequential(*zip(names, js)),
                nn.Sequential(*zip(names, ts)))
    if kind == "sequential_dict":
        names = ("x", "y", "z")
        return (jnn.Sequential(collections.OrderedDict(zip(names, js))),
                nn.Sequential(collections.OrderedDict(zip(names, ts))))
    if kind == "layer_list":
        jl, tl = jnn.LayerList(js[:2]), nn.LayerList(ts[:2])
        jl.append(js[2])
        tl.append(ts[2])
        return jl, tl
    jd = jnn.LayerDict({"b": js[0], "a": js[1]})
    td = nn.LayerDict({"b": ts[0], "a": ts[1]})
    jd["c"], td["c"] = js[2], ts[2]
    return jd, td


def _chain(container, x, kind):
    if kind.startswith("sequential"):
        return container(x)
    layers = container.values() if kind == "layer_dict" else container
    for layer in layers:
        x = layer(x)
    return x


@pytest.mark.parametrize("kind", ["sequential", "sequential_named",
                                  "sequential_dict", "layer_list",
                                  "layer_dict"])
def test_container_names_and_outputs_match_reference(kind):
    jc, tc = _build(kind)
    names, values = jc.functional_state()
    assert names == [n for n, _ in tc.named_parameters()]
    load_jax_state(tc, names, [np.asarray(v) for v in values])
    assert len(tc) == len(jc)
    x = _x(6, (2, 6))
    np.testing.assert_allclose(
        _chain(tc, torch.from_numpy(x), kind).detach().numpy(),
        _np(_chain(jc, paddle.to_tensor(x), kind)), **TOL)


def test_container_indexing_follows_the_reference():
    jc, tc = _build("sequential")
    # a slice is numbered from 0 again, as the reference rebuilds it
    assert ([n for n, _ in tc[1:].named_parameters()]
            == jc[1:].functional_state()[0])
    jl, tl = _build("layer_list")
    tl.insert(1, nn.Linear(6, 6, generator=torch.Generator(), device="cpu"))
    jl.insert(1, jnn.Linear(6, 6))
    assert ([n for n, _ in tl.named_parameters()]
            == jl.functional_state()[0])
    jd, td = _build("layer_dict")
    assert list(td.keys()) == list(jd.keys()) == ["b", "a", "c"]
    del td["a"]
    del jd["a"]
    assert "a" not in td and len(td) == len(jd) == 2


def test_parameter_list_matches_reference():
    values = [np.full((2, 3), i, np.float32) for i in range(3)]
    jp = jnn.ParameterList([paddle.create_parameter(
        [2, 3], "float32", default_initializer=jnn.initializer.Assign(v))
        for v in values])
    tp = nn.ParameterList([torch.nn.Parameter(torch.from_numpy(v))
                           for v in values])
    assert ([n for n, _ in tp.named_parameters()]
            == jp.functional_state()[0] == ["0", "1", "2"])
    tp.append(torch.nn.Parameter(torch.zeros(1)))
    assert len(tp) == 4 and float(tp[2].detach()[0, 0]) == 2.0
