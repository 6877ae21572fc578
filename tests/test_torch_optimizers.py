"""The port's optimizers (``paddle_tpu_torch/optimizer/optimizers.py``)
against the JAX package's, step by step on the same numbers.

Two parameters, a ``[6, 5]`` weight and a ``[5]`` bias named
``layer.bias``, take three steps of seeded gradients through the
reference's eager ``Optimizer.step()`` and through the port's; after each
step the parameters and every slot must agree. The per-parameter decay
options (AdamW's ``apply_decay_param_fun``, Lamb's
``exclude_from_weight_decay_fn``, LarsMomentum's
``exclude_from_weight_decay``) exclude the bias by its name in both
packages.

Tolerances: float32 parameters rtol 1e-5 / atol 1e-6 (the two sides round
the same float32 formulas in another order or with another fusion; three
steps of Adam-family rules amplify an ulp a little). bfloat16 parameters:
one bf16 ulp of the value (rtol 2^-7) plus 1e-6, because a float32 result
a few ulps apart may round to the neighbouring bf16, and for SGD, Momentum
and RMSProp, which compute in bf16, XLA may fuse an expression and round
once where PyTorch rounds each op. Slots are held to the same tolerance
as their parameter's dtype computes them in.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.optimizer as jopt
from paddle_tpu.core.tensor import Parameter as JaxParameter, Tensor as JaxT
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.core.tensor import Parameter

STEPS = 3
LR = 0.05


def _decay_fn(name):
    return "bias" not in name


def _exclude_fn(param):
    return "bias" in param.name


# (name, constructor keyword arguments shared by both packages)
CASES = [
    ("SGD", dict(learning_rate=LR, weight_decay=0.01)),
    ("Momentum", dict(learning_rate=LR, momentum=0.9, weight_decay=0.01)),
    ("Momentum", dict(learning_rate=LR, momentum=0.8, use_nesterov=True)),
    ("LarsMomentum", dict(learning_rate=LR, lars_coeff=0.01,
                          lars_weight_decay=0.01,
                          exclude_from_weight_decay=["bias"])),
    ("Adam", dict(learning_rate=LR, weight_decay=0.01)),
    ("AdamW", dict(learning_rate=LR, weight_decay=0.1,
                   apply_decay_param_fun=_decay_fn)),
    ("Adamax", dict(learning_rate=LR, weight_decay=0.01)),
    ("Lamb", dict(learning_rate=LR, lamb_weight_decay=0.1,
                  exclude_from_weight_decay_fn=_exclude_fn)),
    ("RMSProp", dict(learning_rate=LR, momentum=0.5)),
    ("RMSProp", dict(learning_rate=LR, centered=True, weight_decay=0.01)),
    ("Adagrad", dict(learning_rate=LR, initial_accumulator_value=0.1)),
    ("Adadelta", dict(learning_rate=1.0, rho=0.9)),
]


def _values(seed):
    rng = np.random.RandomState(seed)
    params = [rng.randn(6, 5).astype(np.float32),
              rng.randn(5).astype(np.float32)]
    grads = [[rng.randn(*p.shape).astype(np.float32) for p in params]
             for _ in range(STEPS)]
    return params, grads


def _tol(dtype):
    if dtype == "float32":
        return dict(rtol=1e-5, atol=1e-6)
    return dict(rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=["%s-%d" % (c[0], i) for i, c in
                              enumerate(CASES)])
def test_optimizer_steps_match_reference(case, dtype):
    name, kw = CASES[case]
    params, grads = _values(case)
    names = ("layer.weight", "layer.bias")
    jparams = [JaxParameter(jnp.asarray(p, dtype=dtype), name=n)
               for p, n in zip(params, names)]
    tparams = []
    for p, n in zip(params, names):
        tp = Parameter(torch.from_numpy(p).to(getattr(torch, dtype)))
        tp.name = n
        tparams.append(tp)
    jo = getattr(jopt, name)(parameters=jparams, **kw)
    to = getattr(opt, name)(parameters=tparams, **kw)
    assert to._slots() == jo._slots()
    tol = _tol(dtype)
    for step in range(STEPS):
        for jp, tp, g in zip(jparams, tparams, grads[step]):
            jp.grad = JaxT(jnp.asarray(g, dtype=dtype))
            tp.grad = torch.from_numpy(g).to(tp.dtype)
        jo.step()
        to.step()
        for i, (jp, tp) in enumerate(zip(jparams, tparams)):
            assert tp.dtype == getattr(torch, dtype)
            np.testing.assert_allclose(
                tp.detach().float().numpy(),
                np.asarray(jp._value, np.float32), **tol,
                err_msg="%s step %d param %d" % (name, step + 1, i))
        jsd, tsd = jo.state_dict(), to.state_dict()
        assert sorted(jsd) == sorted(tsd)
        assert tsd["global_step"] == jsd["global_step"] == step + 1
        for key in jsd:
            if key == "global_step":
                continue
            want = np.asarray(jsd[key]._value)
            got = tsd[key]
            # slots live in the dtype the reference keeps them in
            assert got.dtype == getattr(torch, str(want.dtype)), key
            np.testing.assert_allclose(got.float().numpy(),
                                       want.astype(np.float32), **tol,
                                       err_msg="%s %s" % (name, key))


def test_decay_options_exclude_by_name():
    """Excluded parameters take no decay: with zero gradients AdamW and
    Lamb leave the bias where it is and shrink the weight."""
    for cls, kw in ((opt.AdamW, dict(weight_decay=0.5,
                                     apply_decay_param_fun=_decay_fn)),
                    (opt.Lamb, dict(lamb_weight_decay=0.5,
                                    exclude_from_weight_decay_fn=_exclude_fn))):
        w, b = Parameter(torch.ones(4)), Parameter(torch.ones(4))
        w.name, b.name = "fc.weight", "fc.bias"
        o = cls(learning_rate=0.1, parameters=[w, b], **kw)
        for p in (w, b):
            p.grad = torch.zeros(4)
        o.step()
        assert torch.all(w < 1) and torch.equal(b.detach(), torch.ones(4))


def test_adamw_takes_the_reference_parameter_order():
    def params(fn):
        return [(p.name, p.default)
                for p in inspect.signature(fn).parameters.values()]
    assert params(opt.AdamW) == params(jopt.AdamW)
    p = Parameter(torch.ones(3))
    p.grad = torch.full((3,), 0.5)
    clip = opt.ClipGradByGlobalNorm(1.0)
    # the reference's positional order: ..., weight_decay, lr_ratio,
    # apply_decay_param_fun, grad_clip
    o = opt.AdamW(0.1, 0.9, 0.999, 1e-8, [p], 0.01, None, None, clip)
    assert o._grad_clip is clip and o._apply_decay_param_fun is None
    o.step()
    assert o._global_step == 1


def test_lr_ratio_raises_instead_of_being_dropped():
    p = Parameter(torch.ones(3))
    with pytest.raises(NotImplementedError, match="lr_ratio"):
        opt.AdamW(0.1, 0.9, 0.999, 1e-8, [p], 0.01, lambda n: 1.0)
    with pytest.raises(NotImplementedError, match="lr_ratio"):
        opt.AdamW(learning_rate=0.1, parameters=[p], lr_ratio=lambda n: 1.0)
    # a positional lr_ratio is never taken as grad_clip
    with pytest.raises(NotImplementedError, match="lr_ratio"):
        opt.AdamW(0.1, 0.9, 0.999, 1e-8, [p], 0.01,
                  opt.ClipGradByGlobalNorm(1.0))


@pytest.mark.parametrize("name", ["SGD", "Momentum", "LarsMomentum", "Adam",
                                  "Adamax", "Lamb", "RMSProp", "Adagrad",
                                  "Adadelta"])
def test_signatures_match_the_reference(name):
    def params(fn):
        return [(p.name, p.default)
                for p in inspect.signature(fn).parameters.values()]
    assert params(getattr(opt, name)) == params(getattr(jopt, name))
