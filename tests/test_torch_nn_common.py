"""The port's common functionals and layers and its four manipulation
ops against the JAX package's, on the same numpy inputs from a seed.

Each functional case runs forward and backward in both packages: the
port's autograd gradients against ``jax.vjp`` of the reference's raw
function (compiled) on the same random cotangent. Tolerance: ``rtol =
1e-5`` of the largest magnitude of the reference's array (float32 ops
over at most a few dozen terms a sum); integer and boolean outputs must
be equal. The cases cover every ``pad`` mode in both list forms and both
data formats, every ``interpolate`` mode shrinking and growing (with and
without ``align_corners``, channel-last too), every ``grid_sample`` mode
x padding x ``align_corners``, ``fold`` / ``unfold`` at a stride and a
dilation above 1 with uneven padding. The dropouts draw other numbers
than the reference's JAX stream, so they are held to their law: the
share kept, whole channels dropped, the scale, ``alpha_dropout``'s
moments, the identity outside training. The layers are built in both
packages, their parameters carried across by ``load_jax_state``.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.nn import functional as jF
from paddle_tpu.ops import manipulation as jops
from paddle_tpu_torch import nn
from paddle_tpu_torch import ops
from paddle_tpu_torch.models import export_state, load_jax_state
from paddle_tpu_torch.nn import functional as F
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-5


def close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(getattr(want, "_value", want))
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(scale, 1e-6))


def _rand(rng, shape, lo=-1.0, hi=1.0):
    return (lo + (hi - lo) * rng.rand(*shape)).astype(np.float32)


def check_vjp(port_fn, jax_fn, arrays, seed=0, diff=None):
    """Forward, and the gradient of each array of ``arrays`` whose index
    is in ``diff`` (all of them when None)."""
    diff = range(len(arrays)) if diff is None else diff
    ts = [torch.tensor(a, requires_grad=i in diff)
          for i, a in enumerate(arrays)]
    out = port_fn(*ts)
    g = _rand(np.random.RandomState(seed + 100), tuple(out.shape))

    def both(arrays, g):
        out, vjp = jax.vjp(jax_fn, *arrays)
        return out, vjp(g)

    want, grads = jax.jit(both)(arrays, g)
    close(out, want)
    out.backward(torch.from_numpy(g))
    for i in diff:
        got = ts[i].grad                # None: no path reaches the input
        close(torch.zeros_like(ts[i]) if got is None else got, grads[i])


# -- ops/manipulation ---------------------------------------------------

PAD_CASES = [([1, 2, 3, 1], "NCHW"), ([1, 2, 3, 1], "NHWC"),
             ([2, 1], "NCL"), ([2, 0], "NLC"),
             ([0, 0, 1, 2, 2, 3, 1, 1], "NCHW"),
             ([6, 5, 1, 0], "NCHW")]        # wider than the axis


@pytest.mark.parametrize("mode", ["constant", "reflect", "replicate",
                                  "circular"])
@pytest.mark.parametrize("case", range(len(PAD_CASES)))
def test_pad_matches_reference(mode, case):
    widths, fmt = PAD_CASES[case]
    rng = np.random.RandomState(case)
    x = _rand(rng, (2, 3, 5) if fmt in ("NCL", "NLC") else (2, 3, 4, 5))
    kw = dict(mode=mode, value=0.5, data_format=fmt)
    check_vjp(lambda t: ops.pad(t, widths, **kw),
              lambda a: jops.pad.raw_fn(a, widths, **kw), [x], case)


def test_one_hot_and_diag_embed_match_reference():
    ids = np.array([[0, 3, -1, 7], [4, 4, 1, 2]])
    got = ops.one_hot(torch.from_numpy(ids), 5)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jops.one_hot.raw_fn(ids, 5)))
    assert F.one_hot is ops.one_hot and F.diag_embed is ops.diag_embed
    v = _rand(np.random.RandomState(1), (2, 3, 4))
    for args in ((0, -2, -1), (1, 0, 2), (-2, 1, 3), (0, 3, 0), (2, -1, 0)):
        check_vjp(lambda t: ops.diag_embed(t, *args),
                  lambda a: jops.diag_embed.raw_fn(a, *args), [v])


UNFOLD_CASES = [(3, 1, 0, 1), ([2, 3], 2, [1, 0], [1, 2]),
                (2, [1, 2], [1, 0, 2, 1], 2)]


@pytest.mark.parametrize("case", range(len(UNFOLD_CASES)))
def test_unfold_and_fold_match_reference(case):
    """``unfold`` and its transpose ``fold`` (the reference's is the vjp
    of its unfold) at strides, dilations and uneven padding."""
    ks, st, pd, dl = UNFOLD_CASES[case]
    rng = np.random.RandomState(10 + case)
    x = _rand(rng, (2, 3, 7, 8))
    check_vjp(lambda t: F.unfold(t, ks, st, pd, dl),
              lambda a: jops.unfold.raw_fn(a, ks, st, pd, dl), [x], case)
    cols = np.asarray(jops.unfold.raw_fn(x, ks, st, pd, dl))
    y = _rand(rng, cols.shape)
    check_vjp(lambda t: F.fold(t, [7, 8], ks, st, pd, dl),
              lambda a: jF.fold.raw_fn(a, [7, 8], ks, st, pd, dl), [y], case)


# -- nn/functional/common.py --------------------------------------------

INTERP_CASES = [
    # (input shape, kwargs): growing, shrinking, mixed, every mode
    ((2, 3, 5, 6), dict(size=[9, 11], mode="nearest")),
    ((2, 3, 9, 8), dict(size=[4, 3], mode="nearest")),
    ((2, 3, 5, 6), dict(scale_factor=1.7, mode="bilinear")),
    ((2, 3, 9, 10), dict(size=[4, 13], mode="bilinear")),
    ((2, 3, 5, 6), dict(size=[8, 9], mode="bicubic")),
    ((2, 3, 11, 9), dict(size=[5, 4], mode="bicubic")),
    ((2, 3, 9, 10), dict(size=[3, 4], mode="area")),
    ((2, 3, 7), dict(size=[12], mode="linear", data_format="NCL")),
    ((2, 3, 12), dict(scale_factor=[0.4], mode="linear", data_format="NCL")),
    ((1, 2, 4, 5, 6), dict(size=[6, 3, 8], mode="trilinear",
                           data_format="NCDHW")),
    ((1, 2, 4, 5, 6), dict(size=[2, 7, 3], mode="nearest",
                           data_format="NCDHW")),
    ((2, 5, 6, 3), dict(size=[3, 9], mode="bilinear", data_format="NHWC")),
    ((2, 3, 5, 6), dict(size=[9, 4], mode="bilinear", align_corners=True)),
    ((2, 3, 5, 6), dict(size=[7, 1], mode="bicubic", align_corners=True)),
    ((2, 6, 3), dict(size=[10], mode="linear", align_corners=True,
                     data_format="NLC")),
    ((2, 3, 5, 6), dict(size=[3, 8], mode="nearest", align_corners=True)),
]


@pytest.mark.parametrize("case", range(len(INTERP_CASES)),
                         ids=["%s-%d" % (c[1]["mode"], i)
                              for i, c in enumerate(INTERP_CASES)])
def test_interpolate_matches_reference(case):
    shape, kw = INTERP_CASES[case]
    x = _rand(np.random.RandomState(20 + case), shape)
    fn = F.upsample if case % 2 else F.interpolate
    check_vjp(lambda t: fn(t, **kw),
              lambda a: jF.interpolate.raw_fn(a, **kw), [x], case)


GRID_MODES = [(m, p, a) for m in ("bilinear", "nearest")
              for p in ("zeros", "border", "reflection")
              for a in (True, False)]


@pytest.mark.parametrize("mode,padding,align", GRID_MODES)
def test_grid_sample_matches_reference(mode, padding, align):
    rng = np.random.RandomState(30)
    x = _rand(rng, (2, 3, 5, 6))
    grid = _rand(rng, (2, 4, 7, 2), -1.4, 1.4)
    kw = dict(mode=mode, padding_mode=padding, align_corners=align)
    check_vjp(lambda a, g: F.grid_sample(a, g, **kw),
              lambda a, g: jF.grid_sample.raw_fn(a, g, **kw), [x, grid])
    assert F.grid_sample(torch.from_numpy(x), torch.from_numpy(grid)).shape \
        == (2, 3, 4, 7)


def _cases(rng):
    """(name, port call, reference raw call, numpy inputs, differentiated
    inputs)."""
    f = _rand
    ids = rng.randint(0, 7, (3, 5))
    ids[0, :2] = 2
    lens = np.array([[3, 0, 5], [1, 4, 2]])
    theta = f(rng, (2, 2, 3))
    return [
        ("linear", F.linear, jF.linear.raw_fn,
         [f(rng, (2, 3, 4)), f(rng, (4, 5)), f(rng, (5,))], None),
        ("embedding", lambda i, w: F.embedding(i, w, padding_idx=2),
         lambda i, w: jF.embedding.raw_fn(i, w, padding_idx=2),
         [ids, f(rng, (7, 4))], (1,)),
        ("embedding_negative_pad", lambda i, w: F.embedding(
            i, w, padding_idx=-5, sparse=True),
         lambda i, w: jF.embedding.raw_fn(i, w, padding_idx=-5),
         [ids, f(rng, (7, 4))], (1,)),
        ("normalize", lambda a: F.normalize(a, p=3.0, axis=-1),
         lambda a: jF.normalize.raw_fn(a, p=3.0, axis=-1),
         [f(rng, (3, 4, 5))], None),
        ("normalize_l2", F.normalize, jF.normalize.raw_fn,
         [f(rng, (3, 4, 5))], None),
        ("cosine_similarity", lambda a, b: F.cosine_similarity(a, b, axis=2),
         lambda a, b: jF.cosine_similarity.raw_fn(a, b, axis=2),
         [f(rng, (3, 4, 5)), f(rng, (3, 4, 5))], None),
        ("label_smooth", F.label_smooth, jF.label_smooth.raw_fn,
         [f(rng, (3, 6), 0, 1)], None),
        ("label_smooth_prior", lambda a, p: F.label_smooth(a, p, 0.2),
         lambda a, p: jF.label_smooth.raw_fn(a, p, 0.2),
         [f(rng, (3, 6), 0, 1), f(rng, (1, 6), 0, 1)], None),
        ("pixel_shuffle", lambda a: F.pixel_shuffle(a, 2),
         lambda a: jF.pixel_shuffle.raw_fn(a, 2), [f(rng, (2, 8, 3, 4))],
         None),
        ("pixel_shuffle_nhwc", lambda a: F.pixel_shuffle(a, 2, "NHWC"),
         lambda a: jF.pixel_shuffle.raw_fn(a, 2, "NHWC"),
         [f(rng, (2, 3, 4, 8))], None),
        ("pixel_unshuffle", lambda a: F.pixel_unshuffle(a, 2),
         lambda a: jF.pixel_unshuffle.raw_fn(a, 2), [f(rng, (2, 3, 4, 6))],
         None),
        ("pixel_unshuffle_nhwc", lambda a: F.pixel_unshuffle(a, 3, "NHWC"),
         lambda a: jF.pixel_unshuffle.raw_fn(a, 3, "NHWC"),
         [f(rng, (2, 6, 3, 2))], None),
        ("bilinear", F.bilinear, jF.bilinear.raw_fn,
         [f(rng, (4, 3)), f(rng, (4, 5)), f(rng, (6, 3, 5)), f(rng, (6,))],
         None),
        ("affine_grid", lambda t: F.affine_grid(t, (2, 3, 4, 5)),
         lambda t: jF.affine_grid.raw_fn(t, (2, 3, 4, 5)), [theta], None),
        ("affine_grid_half", lambda t: F.affine_grid(
            t, (2, 3, 1, 6), align_corners=False),
         lambda t: jF.affine_grid.raw_fn(t, (2, 3, 1, 6),
                                         align_corners=False),
         [theta], None),
        ("temporal_shift", lambda a: F.temporal_shift(a, 3, 0.25),
         lambda a: jF.temporal_shift.raw_fn(a, 3, 0.25),
         [f(rng, (6, 8, 2, 3))], None),
        ("temporal_shift_nhwc", lambda a: F.temporal_shift(
            a, 2, 0.2, data_format="NHWC"),
         lambda a: jF.temporal_shift.raw_fn(a, 2, 0.2, data_format="NHWC"),
         [f(rng, (4, 2, 3, 10))], None),
        ("channel_shuffle", lambda a: F.channel_shuffle(a, 3),
         lambda a: jF.channel_shuffle.raw_fn(a, 3), [f(rng, (2, 6, 2, 3))],
         None),
        ("channel_shuffle_nhwc", lambda a: F.channel_shuffle(a, 2, "NHWC"),
         lambda a: jF.channel_shuffle.raw_fn(a, 2, "NHWC"),
         [f(rng, (2, 2, 3, 8))], None),
        ("zeropad2d", lambda a: F.zeropad2d(a, [1, 0, 2, 3]),
         lambda a: jops.pad.raw_fn(a, [1, 0, 2, 3]), [f(rng, (2, 3, 4, 5))],
         None),
        ("zeropad2d_nhwc", lambda a: F.zeropad2d(a, [1, 2, 0, 1], "NHWC"),
         lambda a: jops.pad.raw_fn(a, [1, 2, 0, 1], data_format="NHWC"),
         [f(rng, (2, 4, 5, 3))], None),
        ("sequence_mask", lambda a: F.sequence_mask(a, 6, "float32"),
         lambda a: jF.sequence_mask.raw_fn(a, 6, "float32"), [lens], ()),
        ("sequence_mask_max", F.sequence_mask, jF.sequence_mask.raw_fn,
         [lens], ()),
    ]


CASE_NAMES = [c[0] for c in _cases(np.random.RandomState(0))]


@pytest.mark.parametrize("case", range(len(CASE_NAMES)), ids=CASE_NAMES)
def test_functionals_match_reference(case):
    name, port, ref, arrays, diff = _cases(np.random.RandomState(40))[case]
    if diff == ():
        got = port(torch.from_numpy(arrays[0]))
        want = np.asarray(ref(arrays[0]))
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.dtype == (torch.float32 if want.dtype == np.float32
                             else torch.int64)
        return
    check_vjp(port, ref, arrays, case, diff)


def _draw(fn, shape, p, seed=0, **kw):
    x = torch.ones(shape)
    return fn(x, p=p, generator=torch.Generator().manual_seed(seed), **kw)


@pytest.mark.parametrize("fn,shape,kw", [
    (F.dropout2d, (8, 64, 5, 6), {}),
    (F.dropout2d, (8, 5, 6, 64), dict(data_format="NHWC")),
    (F.dropout3d, (8, 64, 2, 3, 4), {}),
    (F.dropout3d, (8, 2, 3, 4, 64), dict(data_format="NDHWC"))])
def test_channel_dropouts_drop_whole_channels(fn, shape, kw):
    p = 0.3
    out = _draw(fn, shape, p, **kw)
    ch = 1 if "data_format" not in kw else len(shape) - 1
    per = out.movedim(ch, 1).reshape(shape[0], shape[ch], -1)
    kept = per[:, :, 0] != 0
    # every element of a channel shares its draw; kept ones scale by 1/(1-p)
    assert torch.equal(per != 0, kept[:, :, None].expand_as(per))
    np.testing.assert_allclose(per[kept].numpy(), 1 / (1 - p), rtol=1e-6)
    assert abs(float(kept.float().mean()) - (1 - p)) < 0.08   # 512 draws
    again = _draw(fn, shape, p, **kw)
    assert torch.equal(out, again)
    x = torch.randn(shape)
    assert fn(x, p=p, training=False, **kw) is x
    assert fn(x, p=0.0, **kw) is x


def test_alpha_dropout_moments_and_identity():
    """``a * where(keep, x, -alpha * scale) + b`` keeps a standard normal
    input at zero mean and unit variance (the reference's formula)."""
    p = 0.2
    x = torch.randn(200000, generator=torch.Generator().manual_seed(1))
    out = F.alpha_dropout(x, p=p, generator=torch.Generator().manual_seed(2))
    assert abs(float(out.mean())) < 0.01
    assert abs(float(out.std()) - 1.0) < 0.01
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    a = 1.0 / ((1.0 - p) * (1.0 + p * alpha_p ** 2)) ** 0.5
    dropped = torch.isclose(out, torch.tensor(a * alpha_p - a * alpha_p * p))
    assert abs(float(dropped.float().mean()) - p) < 0.005
    assert F.alpha_dropout(x, p=p, training=False) is x
    layer = nn.AlphaDropout(p)
    layer.eval()
    assert layer(x) is x


# -- nn/layers/common.py ------------------------------------------------

def _jt(x):
    return paddle.to_tensor(x)


# (name, constructor args, constructor kwargs, input shapes)
LAYER_CASES = [
    ("Flatten", (), dict(start_axis=1, stop_axis=2), [(2, 3, 4, 5)]),
    ("Unflatten", (1, [2, 3]), {}, [(2, 6, 4)]),
    ("Identity", (), {}, [(2, 3)]),
    ("Upsample", (), dict(scale_factor=2, mode="bilinear"), [(1, 2, 3, 4)]),
    ("Upsample", (), dict(size=[2, 3], mode="bicubic"), [(1, 2, 5, 7)]),
    ("UpsamplingBilinear2D", (), dict(size=[5, 7]), [(1, 2, 3, 4)]),
    ("UpsamplingNearest2D", (), dict(scale_factor=2), [(1, 2, 3, 4)]),
    ("Pad1D", ([1, 2],), dict(mode="reflect"), [(2, 3, 5)]),
    ("Pad2D", ([1, 2, 0, 1],), dict(mode="replicate", data_format="NHWC"),
     [(2, 3, 4, 2)]),
    ("Pad3D", ([1, 0, 2, 1, 0, 1],), dict(mode="circular"),
     [(1, 2, 3, 4, 5)]),
    ("Pad2D", ([1, 1, 2, 0],), dict(value=0.5), [(2, 3, 4, 5)]),
    ("ZeroPad2D", ([1, 0, 2, 1],), {}, [(2, 3, 4, 5)]),
    ("PixelShuffle", (2,), {}, [(2, 8, 3, 4)]),
    ("PixelUnshuffle", (2,), {}, [(2, 3, 4, 6)]),
    ("ChannelShuffle", (2,), {}, [(2, 4, 3, 3)]),
    ("CosineSimilarity", (), dict(axis=-1), [(3, 5), (3, 5)]),
    ("Unfold", ([2, 3],), dict(strides=2, paddings=1), [(2, 3, 6, 7)]),
    ("Fold", ([6, 7], [2, 3]), dict(strides=2, paddings=1), [(2, 18, 16)]),
    ("Bilinear", (3, 4, 5), {}, [(6, 3), (6, 4)]),
    ("Bilinear", (3, 4, 5), dict(bias_attr=False), [(6, 3), (6, 4)]),
    ("Dropout2D", (0.4,), {}, [(2, 3, 4, 5)]),
    ("Dropout3D", (0.4,), {}, [(2, 3, 4, 5, 2)]),
    ("AlphaDropout", (0.4,), {}, [(2, 3)]),
]


def _jit_layer(jlayer, *arrays):
    values = jlayer.functional_state()[1]
    return jax.jit(lambda v, *a: getattr(
        jlayer.functional_call(v, *a), "_value",
        jlayer.functional_call(v, *a)))(values, *arrays)


@pytest.mark.parametrize("case", range(len(LAYER_CASES)),
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(LAYER_CASES)])
def test_layers_match_reference(case):
    """Forward and parameter names against the reference layer; the
    dropouts in eval mode (identity) and, in training, by the share
    dropped."""
    name, args, kw, shapes = LAYER_CASES[case]
    rng = np.random.RandomState(50 + case)
    arrays = [_rand(rng, s) for s in shapes]
    jlayer = getattr(jnn, name)(*args, **kw)
    cls = getattr(nn, name)
    layer = (cls(*args, device="cpu", **kw) if name == "Bilinear"
             else cls(*args, **kw))
    assert [n for n, _ in layer.named_parameters()] == \
        [n for n, _ in jlayer.named_parameters()]
    if "Dropout" in name:
        layer.eval()
        assert layer(torch.from_numpy(arrays[0])) is not None
        np.testing.assert_array_equal(
            layer(torch.from_numpy(arrays[0])).numpy(), arrays[0])
        layer.train()
        out = layer(torch.ones(64, *shapes[0][1:]))
        # on ones, a kept element is the largest value, a dropped one not
        assert 0.4 * 0.6 < float((out < out.max()).float().mean()) < 0.4 * 1.4
        return
    if list(layer.parameters()):
        names, values = jlayer.functional_state()
        values = [_rand(rng, np.shape(v)) for v in values]
        load_jax_state(layer, names, values)
        for n, v in zip(names, values):
            jlayer.raw_state_tensors()[n]._value = jax.numpy.asarray(v)
        assert export_state(layer)[0] == names
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = layer(*ts)
    close(out, _jit_layer(jlayer, *arrays))
    out.square().sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in ts)


def test_bilinear_initialisation():
    """XavierNormal over the reference's fans of ``[out, in1, in2]``
    (fan_in = in1 * in2, fan_out = out * in2) and a zero bias; drawn from
    the generator."""
    layer = nn.Bilinear(64, 32, 48, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    std = (2.0 / (64 * 32 + 48 * 32)) ** 0.5
    assert abs(float(layer.weight.std()) / std - 1) < 0.02
    assert torch.equal(layer.bias, torch.zeros(48))
    again = nn.Bilinear(64, 32, 48, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    assert torch.equal(layer.weight, again.weight)
