"""The port's losses (``mse_loss`` through ``rnnt_loss``), their layers,
and ``L1Decay``, against the JAX package's.

Each case runs the same numpy inputs (from a seed) through the port and
the reference's raw function: the value, and the gradient of every
floating input (autograd against ``jax.vjp`` of the reference, compiled
as one program, on the same random cotangent), for each reduction the
loss takes. Tolerance: ``rtol = 1e-5`` of the largest magnitude of the
reference's array, 1e-4 for the CTC and RNN-T recursions (log-space sums
over every alignment). ``class_center_sample`` draws from a
``torch.Generator`` where the reference draws from JAX's key stream, so
its test checks properties instead: every positive kept, the sizes, and
labels remapped consistently.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu import regularizer as jreg
from paddle_tpu.nn import functional as jF
from paddle_tpu_torch import nn, optimizer, regularizer
from paddle_tpu_torch.nn import functional as F
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-5
SCAN_RTOL = 1e-4
REDUCTIONS = ("mean", "sum", "none")


def _raw(x):
    return getattr(x, "_value", x)


def _np(x):
    return np.asarray(_raw(x))


def close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _f(rng, *shape, lo=-1.0, hi=1.0):
    return (lo + (hi - lo) * rng.rand(*shape)).astype(np.float32)


def _pm1(rng, *shape):
    return np.where(rng.rand(*shape) < 0.5, -1.0, 1.0).astype(np.float32)


def _logp(rng, *shape):
    x = rng.randn(*shape).astype(np.float32)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _ctc_inputs(rng):
    lp = _logp(rng, 7, 3, 5)                              # [T, N, C]
    labels = np.array([[1, 2, 2], [3, 1, 0], [4, 4, 0]], np.int64)
    return [lp, labels, np.array([7, 6, 5], np.int64),
            np.array([3, 2, 1], np.int64)]


def _rnnt_inputs(rng):
    x = rng.randn(2, 4, 3, 5).astype(np.float32)         # [B, T, U+1, V]
    return [x, np.array([[1, 2], [3, 0]], np.int64),
            np.array([4, 3], np.int64), np.array([2, 1], np.int64)]


def _hsig_tree(rng):
    x, label = _f(rng, 4, 6), np.array([0, 3, 5, 2], np.int64)
    table = np.array([[0, 1, -1], [0, 2, 3], [0, 2, -1], [0, 1, 4]],
                     np.int64)
    code = np.array([[1, 0, 0], [0, 1, 1], [0, 0, 0], [1, 1, 0]],
                    np.float32)
    return [x, label, _f(rng, 5, 6), _f(rng, 5), table, code]


# name -> (inputs(rng), indices of the floating inputs, positional args
# after the inputs, kwargs, reductions, tolerance)
CASES = {
    "mse_loss": (lambda r: [_f(r, 4, 3), _f(r, 4, 3)], (0, 1), (), {},
                 REDUCTIONS),
    "l1_loss": (lambda r: [_f(r, 4, 3), _f(r, 4, 3)], (0, 1), (), {},
                REDUCTIONS),
    "smooth_l1_loss": (lambda r: [_f(r, 4, 5) * 2, _f(r, 4, 5)], (0, 1), (),
                       dict(delta=0.7), REDUCTIONS),
    "huber_loss": (lambda r: [_f(r, 4, 5) * 2, _f(r, 4, 5)], (0, 1), (),
                   dict(delta=0.6), REDUCTIONS),
    "binary_cross_entropy": (
        lambda r: [_f(r, 4, 3, lo=0.02, hi=0.98), _f(r, 4, 3, lo=0, hi=1),
                   _f(r, 3, lo=0.5, hi=2)], (0, 1, 2), (), {}, REDUCTIONS),
    "binary_cross_entropy_with_logits": (
        lambda r: [_f(r, 4, 3) * 4, _f(r, 4, 3, lo=0, hi=1),
                   _f(r, 3, lo=0.5, hi=2)], (0, 1, 2), (), {}, REDUCTIONS),
    "bce_logits_pos_weight": (
        lambda r: [_f(r, 4, 3) * 4, _f(r, 4, 3, lo=0, hi=1),
                   _f(r, 3, lo=0.5, hi=2)], (0, 1, 2), (), {}, REDUCTIONS),
    "kl_div": (lambda r: [_logp(r, 4, 5), _f(r, 4, 5, lo=0, hi=1)], (0, 1),
               (), {}, REDUCTIONS + ("batchmean",)),
    "hinge_embedding_loss": (lambda r: [_f(r, 6, 3) * 2, _pm1(r, 6, 3)],
                             (0,), (), dict(margin=0.8), REDUCTIONS),
    "margin_ranking_loss": (
        lambda r: [_f(r, 8), _f(r, 8), _pm1(r, 8)], (0, 1), (),
        dict(margin=0.2), REDUCTIONS),
    "cosine_embedding_loss": (
        lambda r: [_f(r, 6, 4), _f(r, 6, 4), _pm1(r, 6)], (0, 1), (),
        dict(margin=0.1), REDUCTIONS),
    "triplet_margin_loss": (
        lambda r: [_f(r, 5, 4), _f(r, 5, 4), _f(r, 5, 4)], (0, 1, 2), (),
        dict(margin=0.5, p=3.0, swap=True), REDUCTIONS),
    "log_loss": (lambda r: [_f(r, 4, 1, lo=0.05, hi=0.95),
                            _f(r, 4, 1, lo=0, hi=1)], (0, 1), (), {}, (None,)),
    "square_error_cost": (lambda r: [_f(r, 4, 3), _f(r, 4, 3)], (0, 1), (),
                          {}, (None,)),
    "ctc_loss_dense": (_ctc_inputs, (0,), (), dict(blank=0),
                       REDUCTIONS, SCAN_RTOL),
    "ctc_loss": (_ctc_inputs, (0,), (), dict(norm_by_times=True),
                 ("none", "mean", "sum"), SCAN_RTOL),
    "warpctc": (lambda r: [r.randn(7, 3, 5).astype(np.float32)]
                + _ctc_inputs(r)[1:], (0,), (), {}, (None,), SCAN_RTOL),
    "sigmoid_focal_loss": (
        lambda r: [_f(r, 4, 3) * 3, (r.rand(4, 3) < 0.4).astype(np.float32),
                   np.array([2.0], np.float32)], (0,), (),
        dict(alpha=0.3, gamma=1.5), REDUCTIONS),
    "sigmoid_cross_entropy_with_logits": (
        lambda r: [_f(r, 4, 3) * 3,
                   np.array([[0, 1, -100], [1, 1, 0], [-100, 0, 1],
                             [0, 0, 1]], np.float32)], (0,), (),
        dict(ignore_index=-100, normalize=True), (None,)),
    "margin_cross_entropy": (
        lambda r: [_f(r, 4, 6, lo=-0.95, hi=0.95),
                   np.array([0, 5, 2, 2], np.int64)], (0,), (),
        dict(margin1=1.0, margin2=0.3, margin3=0.1, scale=8.0), REDUCTIONS),
    "hsigmoid_loss": (
        lambda r: [_f(r, 4, 6), np.array([0, 3, 6, 2], np.int64),
                   _f(r, 6, 6), _f(r, 6)], (0, 2, 3), (7,), {}, (None,)),
    "hsigmoid_loss_custom": (_hsig_tree, (0, 2, 3), (), {}, (None,)),
    "soft_margin_loss": (lambda r: [_f(r, 4, 3) * 3, _pm1(r, 4, 3)], (0,),
                         (), {}, REDUCTIONS),
    "multi_label_soft_margin_loss": (
        lambda r: [_f(r, 4, 5) * 3, (r.rand(4, 5) < 0.5).astype(np.float32),
                   _f(r, 5, lo=0.5, hi=2)], (0, 2), (), {}, REDUCTIONS),
    "npair_loss": (lambda r: [_f(r, 6, 4), _f(r, 6, 4),
                              np.array([0, 1, 0, 2, 1, 3], np.float32)],
                   (0, 1), (), dict(l2_reg=0.01), (None,)),
    "dice_loss": (lambda r: [_f(r, 3, 4, 5, lo=0, hi=1),
                             r.randint(0, 5, (3, 4, 1))], (0,), (), {},
                  (None,)),
    "multi_margin_loss": (
        lambda r: [_f(r, 5, 4) * 2, np.array([0, 3, 1, 1, 2], np.int64),
                   _f(r, 4, lo=0.5, hi=2)], (0, 2), (),
        dict(p=2, margin=0.8), REDUCTIONS),
    "pairwise_distance": (lambda r: [_f(r, 5, 4), _f(r, 5, 4)], (0, 1), (),
                          dict(p=1.5, keepdim=True), (None,)),
    "triplet_margin_with_distance_loss": (
        lambda r: [_f(r, 5, 4), _f(r, 5, 4), _f(r, 5, 4)], (0, 1, 2), (),
        dict(margin=0.4, swap=True), REDUCTIONS),
    "rnnt_loss": (_rnnt_inputs, (0,), (), dict(blank=0), REDUCTIONS,
                  SCAN_RTOL),
}
# the reference function a case name runs, where it differs
REF_NAME = {"bce_logits_pos_weight": "binary_cross_entropy_with_logits",
            "hsigmoid_loss_custom": "hsigmoid_loss"}


def _ref(name):
    fn = getattr(jF, REF_NAME.get(name, name))
    return getattr(fn, "raw_fn", fn)


def _call(name, fn, arrays, args, kw, reduction):
    kw = dict(kw)
    if reduction is not None:
        kw["reduction"] = reduction
    if name == "hsigmoid_loss_custom":
        x, label, w, b, table, code = arrays
        return fn(x, label, 6, w, b, path_table=table, path_code=code)
    if name == "bce_logits_pos_weight":
        *rest, pw = arrays
        return fn(*rest, pos_weight=pw, **kw)
    if name == "hsigmoid_loss":
        x, label, w, b = arrays
        return fn(x, label, *args, w, b, **kw)
    if name == "multi_margin_loss":
        x, label, w = arrays
        return fn(x, label, weight=w, **kw)
    return fn(*arrays, *args, **kw)


@pytest.mark.parametrize("name", list(CASES))
def test_loss_matches_reference(name):
    """Every reduction of the loss: the port's values and gradients
    against the reference's, all reductions in one compiled program."""
    make, diff, args, kw, reductions, *tol = CASES[name]
    rtol = tol[0] if tol else RTOL
    arrays = make(np.random.RandomState(sum(map(ord, name))))
    # the reference's ctc_loss raises for mean and sum ("Faults of the
    # reference" 10): the port's are held to its per-sample losses
    ref_reductions = ["none"] if name == "ctc_loss" else list(reductions)
    outs, grads = [], []
    for reduction in reductions:
        ts = [torch.tensor(a, requires_grad=i in diff)
              for i, a in enumerate(arrays)]
        out = _call(name, getattr(F, REF_NAME.get(name, name)), ts, args,
                    kw, reduction)
        outs.append(out)
        grads.append(ts)
    cots = [np.asarray(np.random.RandomState(i).rand(*o.shape), np.float32)
            for i, o in enumerate(outs)]

    def ref(d, cots):
        res = []
        for reduction, g in zip(ref_reductions, cots):
            def fn(*d, reduction=reduction):
                full = [dict(zip(diff, d)).get(i, a)
                        for i, a in enumerate(arrays)]
                return _raw(_call(name, _ref(name), full, args, kw,
                                  reduction))
            o, vjp = jax.vjp(fn, *d)
            res.append((o, vjp(g)))
        return res

    want = jax.jit(ref)([arrays[i] for i in diff],
                        cots[:len(ref_reductions)])
    if name == "ctc_loss":
        per_sample = np.asarray(want[0][0])
        want = want + [(getattr(np, r)(per_sample), None)
                       for r in reductions[1:]]
        # the cause: ``_reduce`` hands a Tensor to jnp
        from paddle_tpu.nn.functional.loss import _reduce
        with pytest.raises(TypeError):
            _reduce(paddle.to_tensor(per_sample), "mean")
    for reduction, out, ts, g, (w_out, w_grads) in zip(
            reductions, outs, grads, cots, want):
        close(out, w_out, rtol)
        if w_grads is None:
            continue
        out.backward(torch.from_numpy(g))
        for i, w in zip(diff, w_grads):
            close(ts[i].grad, w, rtol)


def test_margin_cross_entropy_softmax():
    rng = np.random.RandomState(5)
    x, label = _f(rng, 4, 6, lo=-0.9, hi=0.9), np.array([1, 0, 5, 3])
    loss, sm = F.margin_cross_entropy(torch.from_numpy(x),
                                      torch.from_numpy(label),
                                      return_softmax=True, reduction="none")
    jloss, jsm = jax.jit(lambda x: tuple(map(_raw, jF.margin_cross_entropy
                                             .raw_fn(x, label,
                                                     return_softmax=True,
                                                     reduction="none"))))(x)
    close(loss, jloss)
    close(sm, jsm)


def test_rnnt_fastemit_raises():
    with pytest.raises(NotImplementedError, match="FastEmit"):
        F.rnnt_loss(*map(torch.from_numpy, _rnnt_inputs(
            np.random.RandomState(0))), fastemit_lambda=0.001)


def test_triplet_margin_with_a_distance_function():
    rng = np.random.RandomState(6)
    a, p, n = _f(rng, 5, 4), _f(rng, 5, 4), _f(rng, 5, 4)

    def l1(u, v):
        return (u - v).abs().sum(-1)

    got = F.triplet_margin_with_distance_loss(
        *map(torch.from_numpy, (a, p, n)), distance_function=l1,
        reduction="none")
    want = jF.triplet_margin_with_distance_loss(
        *map(paddle.to_tensor, (a, p, n)), distance_function=l1,
        reduction="none")
    close(got, want)


def test_class_center_sample_properties():
    label = torch.tensor([3, 17, 3, 40, 8, 17])
    gen = torch.Generator().manual_seed(0)
    remapped, sampled = F.class_center_sample(label, 50, 10, generator=gen)
    positives = sorted(set(label.tolist()))
    assert sampled[:4].tolist() == positives                # kept, first
    assert sampled.numel() == 10
    assert len(set(sampled.tolist())) == 10
    extra = sampled[4:].tolist()
    assert extra == sorted(extra) and not set(extra) & set(positives)
    assert torch.equal(sampled[remapped], label)            # consistent
    again = F.class_center_sample(label, 50, 10,
                                  generator=torch.Generator().manual_seed(0))
    assert torch.equal(again[1], sampled)
    # fewer classes than samples: every class, as in the reference
    _, every = F.class_center_sample(label, 41, 100, generator=gen)
    assert every.numel() == 41
    jremapped, jsampled = jF.class_center_sample(label.numpy(), 50, 10)
    assert _np(jsampled)[:4].tolist() == positives
    assert _np(jsampled).size == 10
    with pytest.raises(NotImplementedError, match="A.7"):
        F.class_center_sample(label, 50, 10, group=object())


# (layer, constructor kwargs, inputs(rng))
LAYERS = [
    ("MSELoss", dict(reduction="sum"), lambda r: [_f(r, 3, 2), _f(r, 3, 2)]),
    ("L1Loss", {}, lambda r: [_f(r, 3, 2), _f(r, 3, 2)]),
    ("SmoothL1Loss", dict(delta=0.5), lambda r: [_f(r, 3, 2), _f(r, 3, 2)]),
    ("BCELoss", {}, lambda r: [_f(r, 3, 2, lo=0.1, hi=0.9),
                               _f(r, 3, 2, lo=0, hi=1)]),
    ("BCEWithLogitsLoss", {}, lambda r: [_f(r, 3, 2), _f(r, 3, 2, lo=0)]),
    ("KLDivLoss", dict(reduction="batchmean"),
     lambda r: [_logp(r, 3, 4), _f(r, 3, 4, lo=0)]),
    ("MarginRankingLoss", dict(margin=0.1),
     lambda r: [_f(r, 5), _f(r, 5), _pm1(r, 5)]),
    ("CosineEmbeddingLoss", {}, lambda r: [_f(r, 3, 4), _f(r, 3, 4),
                                           _pm1(r, 3)]),
    ("TripletMarginLoss", dict(p=1.0),
     lambda r: [_f(r, 3, 4), _f(r, 3, 4), _f(r, 3, 4)]),
    ("HingeEmbeddingLoss", {}, lambda r: [_f(r, 3, 2), _pm1(r, 3, 2)]),
    ("CTCLoss", dict(reduction="sum"), _ctc_inputs),
    ("SoftMarginLoss", {}, lambda r: [_f(r, 3, 2), _pm1(r, 3, 2)]),
    ("MultiLabelSoftMarginLoss", {},
     lambda r: [_f(r, 3, 4), (r.rand(3, 4) < 0.5).astype(np.float32)]),
    ("MultiMarginLoss", dict(margin=0.5),
     lambda r: [_f(r, 3, 4), np.array([0, 3, 2], np.int64)]),
    ("PairwiseDistance", dict(p=3.0), lambda r: [_f(r, 3, 4), _f(r, 3, 4)]),
    ("TripletMarginWithDistanceLoss", dict(margin=0.3),
     lambda r: [_f(r, 3, 4), _f(r, 3, 4), _f(r, 3, 4)]),
    ("RNNTLoss", dict(reduction="sum"), _rnnt_inputs),
    ("CrossEntropyLoss", dict(label_smoothing=0.1),
     lambda r: [_f(r, 3, 5), np.array([0, 4, 2], np.int64)]),
    ("NLLLoss", {}, lambda r: [_logp(r, 3, 5), np.array([0, 4, 2])]),
]


@pytest.mark.parametrize("case", range(len(LAYERS)),
                         ids=[c[0] for c in LAYERS])
def test_loss_layers_match_reference(case):
    name, kw, make = LAYERS[case]
    arrays = make(np.random.RandomState(100 + case))
    got = getattr(nn, name)(**kw)(*map(torch.from_numpy, arrays))
    jlayer = getattr(jnn, name)(**kw)
    want = jax.jit(lambda *a: _raw(jlayer(*a)))(*arrays)
    close(got, want, SCAN_RTOL if name in ("CTCLoss", "RNNTLoss") else RTOL)


def test_hsigmoid_loss_layer():
    """The layer's tree weights (``[num_classes - 1, feature]``, bias
    zeros) feed ``hsigmoid_loss``; with the reference's weights carried
    across, the losses agree."""
    from paddle_tpu_torch.models import load_jax_state

    jlayer = jnn.HSigmoidLoss(6, 7)
    layer = nn.HSigmoidLoss(6, 7, device="cpu")
    assert tuple(layer.weight.shape) == (6, 6)
    assert float(layer.bias.abs().max()) == 0.0
    names, values = jlayer.functional_state()
    values = [np.asarray(v) + np.random.RandomState(8).rand(*np.shape(v))
              .astype(np.float32) for v in values]
    load_jax_state(layer, names, values)
    rng = np.random.RandomState(7)
    x, label = _f(rng, 4, 6), np.array([0, 3, 6, 2])
    close(layer(torch.from_numpy(x), torch.from_numpy(label)),
          jax.jit(lambda v, x: _raw(jlayer.functional_call(v, x, label)))(
              values, x))
    assert nn.HSigmoidLoss(6, 7, bias_attr=False, device="cpu").bias is None


def test_l1_decay_raises_instead_of_decaying_as_l2():
    """"Faults of the reference" 6: the reference folds any regularizer's
    coefficient in as L2, so its ``L1Decay(c)`` steps exactly like
    ``L2Decay(c)``; the port builds an ``L1Decay`` and every optimizer
    given one raises, naming the fault."""
    steps = []
    for decay in (jreg.L1Decay(0.1), jreg.L2Decay(0.1)):
        p = jnn.Linear(2, 2)
        p.weight.set_value(np.full((2, 2), 0.5, np.float32))
        opt = paddle.optimizer.SGD(0.1, parameters=[p.weight],
                                   weight_decay=decay)
        p.weight.grad = paddle.to_tensor(np.zeros((2, 2), np.float32))
        opt.step()
        steps.append(_np(p.weight))
    np.testing.assert_array_equal(steps[0], steps[1])
    np.testing.assert_allclose(steps[0], 0.5 - 0.1 * 0.1 * 0.5)
    decay = regularizer.L1Decay(0.1)
    assert decay._coeff == 0.1 and optimizer.L1Decay is regularizer.L1Decay
    w = torch.nn.Parameter(torch.ones(2))
    for cls in (optimizer.SGD, optimizer.Momentum, optimizer.Adam,
                optimizer.AdamW, optimizer.RMSProp, optimizer.Adagrad):
        with pytest.raises(NotImplementedError, match="Faults of the "):
            cls(learning_rate=0.1, parameters=[w], weight_decay=decay)
    opt = optimizer.SGD(0.1, parameters=[w],
                        weight_decay=regularizer.L2Decay(0.1))
    w.grad = torch.zeros(2)
    opt.step()
    assert torch.allclose(w.detach(), torch.full((2,), 1 - 0.1 * 0.1))
