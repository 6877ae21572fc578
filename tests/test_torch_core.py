"""The port's core (``paddle_tpu_torch.core``: dtype, enforce, place,
scalar, dispatch, autograd) and ``framework.random`` against the JAX
package's, on the CPU.

Values are compared exactly where both sides compute them the same way
(names, classes, scalars), and gradients at float32 1e-5 relative / 1e-6
absolute (``sin`` and ``exp`` on both sides are within a few ulps).
Random streams cannot match the reference's (JAX's counter-based PRNG
against PyTorch's generators): the tests hold the port's random state to
the reference's contract instead (the same seed gives the same draws,
a saved state replays them, a named state draws apart from the global
one).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.autograd as jautograd
from paddle_tpu.core import dtype as jdtype
from paddle_tpu.core import enforce as jenforce
from paddle_tpu.core import scalar as jscalar
from paddle_tpu.core.tensor import Tensor as JT
import paddle_tpu_torch as pt
import paddle_tpu_torch.autograd as autograd
from paddle_tpu_torch.core import dispatch, dtype, enforce, place, scalar
from paddle_tpu_torch.framework import random as prandom

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu_place():
    place.set_device("cpu")
    yield
    place._current_place = None


# -- dtype --------------------------------------------------------------------

SPECS = (list(jdtype._DTYPE_TABLE) + list(jdtype._ALIASES)
         + [np.float32, np.dtype("int16"), "float", "bf16"])


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_dtype_names_match_the_reference(spec):
    name = dtype.canonical_name(spec)
    assert name == jdtype.canonical_name(spec)
    assert dtype.to_torch(spec) == getattr(torch, name)
    assert dtype.canonical_name(dtype.to_torch(spec)) == name
    assert dtype.is_floating(spec) == jdtype.is_floating(spec)
    assert dtype.is_integer(spec) == jdtype.is_integer(spec)
    assert dtype.is_complex(spec) == jdtype.is_complex(spec)


def test_dtype_groups_and_default():
    assert dtype.FLOATING_DTYPES == jdtype.FLOATING_DTYPES
    assert dtype.INTEGER_DTYPES == jdtype.INTEGER_DTYPES
    assert dtype.COMPLEX_DTYPES == jdtype.COMPLEX_DTYPES
    for bad in ("int32", "bool"):
        with pytest.raises(TypeError):
            dtype.set_default_dtype(bad)
        with pytest.raises(TypeError):
            jdtype.set_default_dtype(bad)
    for mod in (dtype, jdtype):
        with pytest.raises(TypeError, match="Unknown dtype"):
            mod.canonical_name("float8")
    try:
        pt.set_default_dtype("float64")
        assert pt.get_default_dtype() == "float64"
        assert pt.ones([2]).dtype == torch.float64
        assert pt.to_tensor([1.5]).dtype == torch.float64
    finally:
        pt.set_default_dtype("float32")
    assert pt.dtype("fp16") == "float16"


# -- enforce ------------------------------------------------------------------

ERRORS = [n for n in jenforce.__all__ if n[0].isupper()]


@pytest.mark.parametrize("name", ERRORS)
def test_typed_errors_keep_the_reference_bases_and_text(name):
    ours, ref = getattr(enforce, name), getattr(jenforce, name)
    assert [b.__name__ for b in ours.__mro__] == \
        [b.__name__ for b in ref.__mro__]
    assert ours.code == ref.code
    a = ours("bad value", hint="try 1", op="add", shape=(2, 3))
    b = ref("bad value", hint="try 1", op="add", shape=(2, 3))
    assert str(a) == str(b)


def test_enforce_helpers_and_the_builtin_map():
    assert {k.__name__: v.__name__ for k, v in
            enforce.BUILTIN_TO_TYPED.items()} == {
        k.__name__: v.__name__ for k, v in jenforce.BUILTIN_TO_TYPED.items()}
    with pytest.raises(ValueError, match="x must be positive"):
        enforce.enforce(False, "x must be positive")
    with pytest.raises(enforce.InvalidArgumentError):
        enforce.enforce_eq(1, 2)
    with pytest.raises(KeyError):
        enforce.enforce_not_none(None, "missing")
    assert enforce.enforce_shape_match((2, 3), (-1, 3))
    with pytest.raises(ConnectionError):
        enforce.raise_native(-2, "pull")


def test_a_primitive_raises_typed_errors_naming_the_op():
    with pytest.raises(enforce.InvalidArgumentError) as err:
        pt.split(torch.ones(5), 2)
    assert isinstance(err.value, ValueError) and err.value.op == "_split_impl"
    assert err.value.context["input_shapes"] == [(5,)]
    with pytest.raises(enforce.OutOfRangeError) as err:
        pt.take(torch.ones(3), torch.tensor([5]))
    assert err.value.op == "take" and "[Operator: take]" in str(err.value)
    with pytest.raises(IndexError):      # still the builtin
        pt.take(torch.ones(3), torch.tensor([5]))


# -- place --------------------------------------------------------------------

def test_places():
    assert place.CPUPlace().torch_device() == torch.device("cpu")
    assert place.CUDAPinnedPlace().torch_device() == torch.device("cpu")
    assert place.CPUPlace() == place.CPUPlace()
    assert place.CUDAPlace(1) != place.CUDAPlace(0)
    assert pt.get_device() == "cpu"
    assert pt.ones([2]).device.type == "cpu"
    assert pt.is_compiled_with_cuda() and not pt.is_compiled_with_tpu()
    assert pt.device_count() == torch.cuda.device_count()
    assert pt.get_all_custom_device_type() == []
    for make in (lambda: place.TPUPlace(0), lambda: place.NPUPlace(0),
                 lambda: place.CustomPlace("x"),
                 lambda: pt.register_custom_device("x", "lib.so"),
                 lambda: pt.set_device("tpu:0")):
        with pytest.raises(enforce.UnimplementedError, match="A.5"):
            make()
    if not torch.cuda.is_available():
        place._current_place = None
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pt.get_device()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pt.set_device("gpu:0")


# -- scalar -------------------------------------------------------------------

@pytest.mark.parametrize("value", [3, 2.5, True, np.float32(1.5),
                                   np.array([7]), "tensor"])
def test_scalar_matches_the_reference(value):
    if value == "tensor":
        ours, ref = scalar.Scalar(torch.tensor([4.0])), \
            jscalar.Scalar(JT(jnp.asarray([4.0])))
    else:
        ours, ref = scalar.Scalar(value), jscalar.Scalar(value)
    assert (ours.to_int(), ours.to_float(), ours.to_bool(), ours.dtype) == \
        (ref.to_int(), ref.to_float(), ref.to_bool(), ref.dtype)
    assert ours == ref._v and repr(ours) == repr(ref)


def test_int_array_matches_the_reference():
    for value in ([1, 2, 3], np.array([4, 5]), 7, (2, 2)):
        assert scalar.IntArray(value).get_data() == \
            jscalar.IntArray(value).get_data()
    assert scalar.IntArray(torch.tensor([3, 4])) == [3, 4]
    assert scalar.IntArray(2, size=3).to_list() == [2, 2, 2]
    with pytest.raises(ValueError):
        scalar.IntArray(np.ones((2, 2)))
    with pytest.raises(ValueError):
        scalar.Scalar(np.ones(3))


# -- random -------------------------------------------------------------------

def _draws():
    return [pt.randn([4]), pt.rand([3]), pt.randint(0, 100, [5]),
            pt.randperm(6), pt.uniform([2], min=2.0, max=3.0),
            pt.bernoulli(torch.full((8,), 0.5)),
            pt.multinomial(torch.tensor([0.2, 0.3, 0.5]), 2),
            pt.poisson(torch.full((4,), 3.0)),
            pt.randint_like(torch.zeros(3), 0, 9)]


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_seed_fixes_every_random_op():
    pt.seed(11)
    first = _draws()
    pt.seed(11)
    again = _draws()
    assert _same(first, again)
    pt.seed(12)
    assert not _same(first, _draws())


def test_rng_state_save_and_restore():
    pt.seed(3)
    pt.randn([2])
    state = pt.get_rng_state()
    a = _draws()
    pt.seed(99)
    pt.set_rng_state(state)
    assert _same(a, _draws())
    # the reference's contract, on the reference
    paddle.seed(3)
    jstate = paddle.get_rng_state()
    ja = np.asarray(paddle.randn([4])._value)
    paddle.set_rng_state(jstate)
    np.testing.assert_array_equal(ja, np.asarray(paddle.randn([4])._value))


def test_rng_states_tracker():
    tracker = prandom.get_rng_state_tracker()
    tracker.reset()
    try:
        pt.seed(5)
        tracker.add("local_seed", 7)
        with pytest.raises(ValueError, match="already added"):
            tracker.add("local_seed", 8)
        with tracker.rng_state("local_seed"):
            assert prandom.in_tracked_rng_state()
            local = pt.randn([6])
        glob = pt.randn([6])
        assert not torch.equal(local, glob)
        saved = tracker.get_states_tracker()
        with tracker.rng_state("local_seed"):
            nxt = pt.randn([6])
        tracker.set_states_tracker(saved)
        with tracker.rng_state("local_seed"):
            assert torch.equal(pt.randn([6]), nxt)
        with tracker.rng_state("auto"):        # registered on first use
            auto = pt.randn([3])
        tracker.reset()
        pt.seed(5)
        with tracker.rng_state("auto"):
            assert torch.equal(pt.randn([3]), auto)
        tracker.reset()
        tracker.set_mp_rank(1)
        tracker.add("local_seed", 7)
        with tracker.rng_state("local_seed"):
            assert not torch.equal(pt.randn([6]), local)
    finally:
        tracker.reset()


def test_random_moments_and_ranges():
    pt.seed(0)
    n = pt.normal(2.0, 0.5, [20000])
    assert abs(float(n.mean()) - 2.0) < 0.02
    assert abs(float(n.std()) - 0.5) < 0.02
    u = pt.uniform([20000], min=-2.0, max=1.0)
    assert float(u.min()) >= -2.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) + 0.5) < 0.03
    r = pt.randint(3, 9, [1000])
    assert r.dtype == torch.int64 and int(r.min()) == 3 and int(r.max()) == 8
    assert sorted(pt.randperm(10).tolist()) == list(range(10))
    s = pt.uniform([4], seed=7)
    assert torch.equal(s, pt.uniform([4], seed=7))


# -- dispatch -----------------------------------------------------------------

def test_primitive_registry_and_nesting():
    from paddle_tpu_torch import amp

    seen = []

    @dispatch.primitive(name="_probe_inner")
    def inner(x):
        seen.append(("inner", x.dtype))
        return x

    @dispatch.primitive(name="_probe_outer")
    def outer(x):
        seen.append(("outer", x.dtype, dispatch.in_primitive()))
        return inner(x * 1)

    try:
        assert dispatch.WRAPPERS["_probe_outer"] is outer
        assert dispatch.OPS["_probe_outer"] is outer.raw_fn
        x = torch.ones(2)
        with amp.auto_cast(level="O2"):
            outer(x)
            pt.cast(x, "float32")
        # the top-level call is cast; the nested one sees raw inputs, and
        # the raw torch call in the body is not cast either
        assert seen == [("outer", torch.bfloat16, True),
                        ("inner", torch.bfloat16)]
        assert not dispatch.in_primitive()
    finally:
        for name in ("_probe_inner", "_probe_outer"):
            dispatch.OPS.pop(name)
            dispatch.WRAPPERS.pop(name)


def test_no_grad_and_enable_grad():
    x = torch.ones(2, requires_grad=True)
    with pt.no_grad():
        assert not (x * 2).requires_grad
        with pt.enable_grad():
            assert (x * 2).requires_grad
    assert pt.is_grad_enabled()

    @pt.no_grad()
    def f(t):
        return t * 2
    assert not f(x).requires_grad


# -- autograd -----------------------------------------------------------------

def _xy(rng):
    return (rng.standard_normal((3, 4)).astype(np.float32),
            rng.standard_normal((3, 4)).astype(np.float32))


def test_grad_matches_the_reference():
    x, y = _xy(np.random.default_rng(0))
    jx, jy = (paddle.to_tensor(v, stop_gradient=False) for v in (x, y))
    jout = (paddle.sin(jx) * jy * jy).sum()
    jg = paddle.grad(jout, [jx, jy])
    tx, ty = (pt.to_tensor(v, stop_gradient=False) for v in (x, y))
    out = (pt.sin(tx) * ty * ty).sum()
    g = pt.grad(out, [tx, ty])
    for a, b in zip(g, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b._value), **TOL)
    assert tx.grad is None          # grad does not accumulate


def test_grad_outputs_create_graph_and_allow_unused():
    x, y = _xy(np.random.default_rng(1))
    seed = np.random.default_rng(2).standard_normal((3, 4)).astype(
        np.float32)
    jx = paddle.to_tensor(x, stop_gradient=False)
    jz = paddle.to_tensor(y, stop_gradient=False)
    jout = paddle.exp(jx) * jx
    jg, = paddle.grad(jout, jx, grad_outputs=paddle.to_tensor(seed),
                      create_graph=True)
    jgg, = paddle.grad(jg.sum(), jx)
    tx = pt.to_tensor(x, stop_gradient=False)
    tz = pt.to_tensor(y, stop_gradient=False)
    out = pt.exp(tx) * tx
    g, = pt.grad(out, tx, grad_outputs=torch.from_numpy(seed),
                 create_graph=True)
    gg, = pt.grad(g.sum(), tx)
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(jg._value),
                               **TOL)
    np.testing.assert_allclose(gg.numpy(), np.asarray(jgg._value), **TOL)
    with pytest.raises(RuntimeError, match="allow_unused=False"):
        pt.grad((tx * 2).sum(), [tx, tz])
    with pytest.raises(RuntimeError, match="allow_unused=False"):
        paddle.grad((jx * 2).sum(), [jx, jz])
    got = pt.grad((tx * 2).sum(), [tx, tz], allow_unused=True)
    want = paddle.grad((jx * 2).sum(), [jx, jz], allow_unused=True)
    assert got[1] is None and want[1] is None
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]._value))


def test_backward_and_saved_tensors_hooks():
    x = pt.to_tensor([1.0, 2.0], stop_gradient=False)
    with pytest.raises(RuntimeError, match="non-scalar"):
        from paddle_tpu_torch.core.autograd import backward
        backward(x * 2)
    autograd.backward([(x * x).sum()])
    assert x.grad.tolist() == [2.0, 4.0]
    packed = []

    def pack(t):
        packed.append(t.shape)
        return t

    with autograd.saved_tensors_hooks(pack, lambda t: t):
        y = (x * x).sum()
    y.backward()
    assert packed


class _JCube(jautograd.PyLayer):
    @staticmethod
    def forward(ctx, x, k):
        ctx.save_for_backward(x)
        ctx.k = k
        return x * x * x * k, x * 2

    @staticmethod
    def backward(ctx, g, g2):
        x, = ctx.saved_tensor()
        return g * 3 * x * x * ctx.k + g2 * 2


class _Cube(autograd.PyLayer):
    @staticmethod
    def forward(ctx, x, k):
        ctx.save_for_backward(x)
        ctx.k = k
        return x * x * x * k, x * 2

    @staticmethod
    def backward(ctx, g, g2):
        x, = ctx.saved_tensor()
        return g * 3 * x * x * ctx.k + g2 * 2


def test_pylayer_matches_the_reference():
    x = np.random.default_rng(3).standard_normal(5).astype(np.float32)
    jx = paddle.to_tensor(x, stop_gradient=False)
    ja, jb = _JCube.apply(jx, 1.5)
    (ja.sum() + (jb * jb).sum()).backward()
    tx = pt.to_tensor(x, stop_gradient=False)
    outs = _Cube.apply(tx, 1.5)
    assert isinstance(outs, list) and len(outs) == 2
    a, b = outs
    (a.sum() + (b * b).sum()).backward()
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(ja._value),
                               **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad._value),
                               **TOL)
    with torch.no_grad():
        a2, _ = _Cube.apply(tx, 1.5)
    assert not a2.requires_grad


@pytest.mark.parametrize("level", [None, "O2"])
def test_recomputed_steps_leave_no_tensor_in_a_reference_cycle(level):
    """``torch.utils.checkpoint`` ends each recomputation by raising through
    the primitives of the layer; an error path that kept the exception in
    a frame of its own traceback would hold every recomputed activation
    until the cyclic collector ran (llama1b's step peaked 6.6 GB higher on
    the card so). After a warm-up step, three more leave none."""
    import gc

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    model = LlamaForCausalLM(LlamaConfig.tiny(recompute=True), device="cpu")
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (2, 12)))

    def cyclic_tensors(steps):
        gc.collect()
        gc.disable()
        try:
            for _ in range(steps):
                with amp.auto_cast(enable=level is not None,
                                   level=level or "O1"):
                    loss = model(ids, ids)
                loss.backward()
            del loss
            gc.set_debug(gc.DEBUG_SAVEALL)
            gc.collect()
            return sum(isinstance(o, torch.Tensor) for o in gc.garbage)
        finally:
            gc.set_debug(0)
            gc.garbage.clear()
            gc.enable()

    cyclic_tensors(1)
    assert cyclic_tensors(3) == 0
