"""The port's ``nn.initializer``, ``ParamAttr`` and ``nn.utils`` against
the JAX package's.

``Constant``, ``Assign`` and ``Dirac`` must give the reference's arrays
exactly; the random initializers draw other numbers than the reference's
JAX stream, so they are held to their laws on 200k draws (the sample
mean within 0.01 of the law's standard deviation, the sample standard
deviation within 1 %, uniform bounds never crossed and approached within
0.1 %), ``Orthogonal``'s ``QᵀQ`` to ``gain² I`` within 1e-5, and
``TruncatedNormal`` to [-2, 2] standard deviations. The fans are the
reference's ``_fans``. ``create_parameter`` keeps ``Layer.
create_parameter``'s order (the attr's initializer, the layer's default,
then the global one) and ``attr=False`` / ``trainable``.

``weight_norm``, ``spectral_norm`` and ``remove_weight_norm`` run on a
``Linear`` and a ``Conv2D`` in both packages with the same weights:
outputs, the parameter names, the gradients of ``weight_g`` /
``weight_v`` / ``weight_orig`` (``jax.grad`` of the reference's
``functional_call``) and the power-iteration vectors within ``rtol =
1e-5`` of the largest magnitude.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.nn import functional as jF
from paddle_tpu.nn import initializer as jinit
from paddle_tpu.nn import utils as jutils
from paddle_tpu_torch import nn
from paddle_tpu_torch.models import export_state, load_jax_state
from paddle_tpu_torch.nn import initializer as init
from paddle_tpu_torch.nn import utils
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-5
N = 200_000


def close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(getattr(want, "_value", want))
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(scale, 1e-6))


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_exact_initializers_equal_reference():
    value = np.arange(24, dtype=np.float32).reshape(2, 3, 4) / 7
    for shape, port, ref in (
            ((3, 4), init.Constant(0.25), jinit.Constant(0.25)),
            ((2, 3, 4), init.Assign(value), jinit.Assign(value)),
            ((2, 3, 4), init.Assign(torch.from_numpy(value)),
             jinit.Assign(value)),
            ((4, 2, 3, 3), init.Dirac(), jinit.Dirac()),
            ((3, 5, 3), init.Dirac(groups=3), jinit.Dirac(groups=3)),
            ((2, 2, 3, 4, 3), init.Dirac(), jinit.Dirac())):
        got = port.create(shape, device="cpu")
        assert isinstance(got, torch.nn.Parameter)
        np.testing.assert_array_equal(got.detach().numpy(),
                                      np.asarray(ref.create(shape)._value))
    bf16 = init.Constant(1.5).create([2], dtype="bfloat16", device="cpu")
    assert bf16.dtype == torch.bfloat16 and bf16.tolist() == [1.5, 1.5]


@pytest.mark.parametrize("shape", [(7,), (6, 5), (4, 3, 2, 5), (8, 2, 3)])
def test_fans_are_the_reference(shape):
    assert init._fans(shape) == jinit._fans(shape)


def _law(make, shape=(N // 100, 100)):
    return make.create(shape, device="cpu", generator=gen(3)).detach()


@pytest.mark.parametrize("make,mean,std,limit", [
    (init.Normal(0.5, 2.0), 0.5, 2.0, None),
    (init.Uniform(-0.3, 0.7), 0.2, 1.0 / 12 ** 0.5, (-0.3, 0.7)),
    (init.XavierNormal(), 0.0, (2 / (2000 + 100)) ** 0.5, None),
    (init.XavierNormal(fan_in=10, fan_out=30, gain=2.0), 0.0,
     2.0 * (2 / 40) ** 0.5, None),
    (init.XavierUniform(), 0.0, (2 / 2100) ** 0.5,
     (-(6 / 2100) ** 0.5, (6 / 2100) ** 0.5)),
    (init.KaimingNormal(), 0.0, (2 / 2000) ** 0.5, None),
    (init.KaimingNormal(fan_in=50, negative_slope=0.5,
                        nonlinearity="leaky_relu"), 0.0,
     (2 / 1.25) ** 0.5 / 50 ** 0.5, None),
    (init.KaimingNormal(nonlinearity="tanh"), 0.0, 1 / 2000 ** 0.5, None),
    (init.KaimingUniform(), 0.0, (2 / 2000) ** 0.5,
     (-(6 / 2000) ** 0.5, (6 / 2000) ** 0.5)),
])
def test_random_initializers_follow_their_law(make, mean, std, limit):
    w = _law(make)
    assert abs(float(w.mean()) - mean) < 0.01 * std
    assert abs(float(w.std()) / std - 1) < 0.01
    if limit is not None:
        lo, hi = limit
        assert lo <= float(w.min()) < lo + 1e-3 * (hi - lo)
        assert hi - 1e-3 * (hi - lo) < float(w.max()) <= hi
    assert torch.equal(w, _law(make))                 # from the generator


def test_truncated_normal_and_orthogonal():
    w = _law(init.TruncatedNormal(1.0, 0.5))
    assert float(w.min()) >= 0.0 and float(w.max()) <= 2.0
    assert abs(float(w.mean()) - 1.0) < 0.005
    # a standard normal truncated to [-2, 2] has std 0.8796
    assert abs(float(w.std()) / (0.5 * 0.87962566) - 1) < 0.01
    for shape in ((6, 4), (3, 8), (4, 2, 5)):
        q = init.Orthogonal(gain=1.5).create(shape, device="cpu",
                                             generator=gen(1)).detach()
        m = q.reshape(-1, shape[-1])
        small = m.T @ m if m.shape[0] >= m.shape[1] else m @ m.T
        close(small, 2.25 * np.eye(small.shape[0], dtype=np.float32))


def test_call_fills_in_place_under_no_grad():
    p = init.Constant(0.0).create([3, 4], device="cpu")
    out = init.Uniform(-0.1, 0.1)(p, generator=gen(2))
    assert out is p and p.requires_grad and p.grad_fn is None
    assert 0 < float(p.abs().max()) <= 0.1


def test_create_parameter_precedence():
    """The attr's initializer, else the layer's default, else the global
    one (XavierNormal / zeros when none is set)."""
    attr = nn.ParamAttr(name="w", initializer=init.Constant(3.0),
                        trainable=False)
    p = init.create_parameter([2], attr, default_initializer=init.Constant(
        1.0), device="cpu")
    assert p.tolist() == [3.0, 3.0] and not p.requires_grad and p.name == "w"
    p = init.create_parameter([2], nn.ParamAttr(), device="cpu",
                              default_initializer=init.Constant(1.0))
    assert p.tolist() == [1.0, 1.0] and p.requires_grad
    p = init.create_parameter([2], {"initializer": init.Constant(4.0)},
                              device="cpu")
    assert p.tolist() == [4.0, 4.0]
    assert init.create_parameter([2], False, device="cpu") is None
    assert init.create_parameter([3], is_bias=True, device="cpu").tolist() \
        == [0.0] * 3
    try:
        init.set_global_initializer(init.Constant(5.0), init.Constant(6.0))
        assert init.create_parameter([1], device="cpu").tolist() == [5.0]
        assert init.create_parameter([1], is_bias=True,
                                     device="cpu").tolist() == [6.0]
        # a layer's default wins over the global one
        assert init.create_parameter(
            [1], default_initializer=init.Constant(7.0),
            device="cpu").tolist() == [7.0]
        layer = nn.Bilinear(2, 3, 4, device="cpu")
        assert set(layer.weight.flatten().tolist()) == {5.0}
        assert set(layer.bias.tolist()) == {6.0}
        # the port's older layers keep their own initialisation
        lin = nn.Linear(3, 4, generator=gen(), device="cpu")
        assert len(set(lin.weight.flatten().tolist())) == 12
    finally:
        init.set_global_initializer(None, None)
    assert isinstance(init.default_weight_init(), init.XavierNormal)
    assert isinstance(init.default_bias_init(), init.Constant)


# -- nn/utils -----------------------------------------------------------

def _pair(kind):
    """A reference layer with weights from numpy and the port's copy."""
    rng = np.random.RandomState(5)
    if kind == "linear":
        jlayer = jnn.Linear(4, 3)
        layer = nn.Linear(4, 3, generator=gen(), device="cpu")
        x = rng.randn(2, 4).astype(np.float32)
    else:
        jlayer = jnn.Conv2D(2, 3, 2)
        layer = nn.Conv2D(2, 3, 2, device="cpu")
        x = rng.randn(2, 2, 4, 4).astype(np.float32)
    names, values = jlayer.functional_state()
    values = [rng.randn(*np.shape(v)).astype(np.float32) for v in values]
    for n, v in zip(names, values):
        jlayer.raw_state_tensors()[n]._value = jax.numpy.asarray(v)
    load_jax_state(layer, names, values)
    return jlayer, layer, x


def _reference(jlayer, x):
    """The reference layer's output on ``x`` and the gradients of
    ``sum(out ** 2)`` by name, compiled as one program."""
    names, values = jlayer.functional_state()

    def loss(values):
        out = jlayer.functional_call(values, JaxTensor(x))._value
        return (out ** 2).sum(), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(values)
    return out, dict(zip(names, grads))


@pytest.mark.parametrize("kind,dim", [("linear", 0), ("linear", 1),
                                      ("conv", 0), ("conv", 2)])
def test_weight_norm_matches_reference(kind, dim):
    jlayer, layer, x = _pair(kind)
    jutils.weight_norm(jlayer, dim=dim)
    assert utils.weight_norm(layer, dim=dim) is layer
    names = jlayer.functional_state()[0]
    assert sorted(export_state(layer)[0]) == sorted(names)
    for n, v in zip(*jlayer.functional_state()):
        close(dict(layer.named_parameters())[n], v)
    out = layer(torch.from_numpy(x))
    want_out, want = _reference(jlayer, x)
    close(out, want_out)
    out.square().sum().backward()
    for n, p in layer.named_parameters():
        close(p.grad, want[n])


def test_remove_weight_norm_folds_and_clears_every_pre_hook():
    """The last forward's weight becomes a plain parameter again; like the
    reference, every forward pre-hook of the layer goes, not only the
    norm's."""
    jlayer, layer, x = _pair("linear")
    jutils.weight_norm(jlayer)
    utils.weight_norm(layer)
    seen = []
    layer.register_forward_pre_hook(lambda m, i: seen.append(1))
    jlayer.register_forward_pre_hook(lambda m, i: None)
    layer(torch.from_numpy(x))
    jlayer(paddle.to_tensor(x))
    utils.remove_weight_norm(layer)
    jutils.remove_weight_norm(jlayer)
    assert not layer._forward_pre_hooks and not jlayer._forward_pre_hooks
    assert sorted(n for n, _ in layer.named_parameters()) == \
        sorted(jlayer.functional_state()[0]) == ["bias", "weight"]
    close(layer.weight, jlayer.weight)
    close(layer(torch.from_numpy(x)), jlayer(paddle.to_tensor(x)))
    assert seen == [1]


@pytest.mark.parametrize("kind,dim,iters", [("linear", None, 1),
                                            ("linear", 1, 3),
                                            ("conv", 0, 2)])
def test_spectral_norm_matches_reference(kind, dim, iters):
    """Two forwards (the vectors persist between them), the parameter
    names and the gradient of ``weight_orig``; ``remove_weight_norm``
    keeps the normalised weight."""
    jlayer, layer, x = _pair(kind)
    jutils.spectral_norm(jlayer, n_power_iterations=iters, dim=dim)
    utils.spectral_norm(layer, n_power_iterations=iters, dim=dim)
    assert sorted(export_state(layer)[0]) == sorted(
        jlayer.functional_state()[0])
    close(layer._sn_u, jlayer._sn_u)
    close(layer._sn_v, jlayer._sn_v)
    for _ in range(2):
        close(layer(torch.from_numpy(x)), jlayer(paddle.to_tensor(x)))
        close(layer._sn_u, jlayer._sn_u)
        close(layer._sn_v, jlayer._sn_v)
    u, v = jlayer._sn_u._value, jlayer._sn_v._value
    layer(torch.from_numpy(x)).square().sum().backward()
    conv = jF.linear if kind == "linear" else jF.conv2d

    def loss(w):
        w_sn = jutils.spectral_norm_weight.raw_fn(w, u, v, dim=dim or 0,
                                                  power_iters=iters)[0]
        return (conv.raw_fn(x, w_sn, jlayer.bias._value) ** 2).sum()

    close(layer.weight_orig.grad,
          jax.jit(jax.grad(loss))(jlayer.weight_orig._value))
    jlayer(paddle.to_tensor(x))
    close(layer.weight, jlayer.weight)
    utils.remove_weight_norm(layer)
    assert sorted(n for n, _ in layer.named_parameters()) == ["bias",
                                                              "weight"]
