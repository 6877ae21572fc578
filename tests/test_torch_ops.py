"""The port's op layer (``paddle_tpu_torch.ops``, ``tensor.attribute``,
the top-level ``paddle.*`` functions) against the JAX package's, on the
CPU: one case an op and dtype, the same numpy inputs from a seed on both
sides, plus the op-coverage gate over the reference's inventory
(``paddle_tpu/ops/ops.yaml``).

Dtypes. The reference runs JAX without x64, so its int64 and float64
results are int32 and float32 ("Faults of the reference" 21 in
ROADMAP.md); the port keeps 64-bit results where Paddle does. Dtypes are
compared after mapping the port's int64 -> int32, float64 -> float32 and
complex128 -> complex64.

Tolerances, by family. Exact (``x``): creation, manipulation, comparison,
integer math and anything that only moves values. float32 (``f``): 1e-5
relative, 1e-6 absolute, sums taken in another order. Transcendental
functions (``t``): 1e-4 relative, 1e-5 absolute (XLA's CPU
transcendentals are fast approximations to ~1e-5 relative, torch's are
libm's). Linear algebra (``l``): 1e-4 relative and absolute on
well-conditioned inputs (other factorization algorithms). bfloat16 and
float16 (every family but exact): both compute in float32 and round, so
one rounding of the output apart at most: 1e-2 / 2e-3 relative and
absolute. Decompositions equal up to the signs of vectors (``svd``,
``qr``, ``eigh``, ``eig``) are compared by their values and
reconstructions; random ops by shape, dtype and range (their moments and
seed-determinism are ``tests/test_torch_core.py``'s).
"""
import re
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.ops as jops
import paddle_tpu.tensor.attribute as jattr
from paddle_tpu.core.tensor import Tensor as JT
import paddle_tpu_torch as pt
import paddle_tpu_torch.ops as tops
import paddle_tpu_torch.tensor.attribute as tattr
from paddle_tpu_torch.core import place
from paddle_tpu_torch.core.dispatch import WRAPPERS
from paddle_tpu_torch.ops import coverage

ROOT = Path(__file__).resolve().parents[1]

TOLS = {"f": dict(rtol=1e-5, atol=1e-6), "t": dict(rtol=1e-4, atol=1e-5),
        "l": dict(rtol=1e-4, atol=1e-4)}
HALF_TOLS = {"bfloat16": dict(rtol=1e-2, atol=1e-2),
             "float16": dict(rtol=2e-3, atol=2e-3)}
NARROW = {"int64": "int32", "float64": "float32", "complex128": "complex64"}
HALF = ("float32", "bfloat16", "float16")


@pytest.fixture(autouse=True, scope="module")
def _cpu_place():
    place.set_device("cpu")
    yield
    place._current_place = None


# -- input specs ----------------------------------------------------------------

class F:
    """A float array of the case's dtype, uniform in [lo, hi)."""

    def __init__(self, *shape, lo=-2.0, hi=2.0):
        self.shape, self.lo, self.hi = shape, lo, hi

    def make(self, rng, dt):
        a = rng.uniform(self.lo, self.hi, self.shape).astype(np.float32)
        return ("float", a, dt)


class I:
    """An int32 array in [lo, hi)."""

    def __init__(self, *shape, lo=0, hi=10, dtype="int32"):
        self.shape, self.lo, self.hi, self.dtype = shape, lo, hi, dtype

    def make(self, rng, dt):
        return ("int", rng.integers(self.lo, self.hi, self.shape).astype(
            self.dtype), self.dtype)


class B:
    """A bool array."""

    def __init__(self, *shape):
        self.shape = shape

    def make(self, rng, dt):
        return ("int", rng.random(self.shape) < 0.5, "bool")


class A:
    """A fixed array (its dtype kept, or the case's for floats)."""

    def __init__(self, value, float_case=False):
        self.value, self.float_case = np.asarray(value), float_case

    def make(self, rng, dt):
        if self.float_case:
            return ("float", self.value.astype(np.float32), dt)
        return ("int", self.value, str(self.value.dtype))


class L:
    """A list of specs."""

    def __init__(self, *items):
        self.items = items

    def make(self, rng, dt):
        return ("list", [i.make(rng, dt) for i in self.items])


def spd(n):
    """A symmetric positive definite float matrix."""
    rng = np.random.default_rng(n)
    m = rng.standard_normal((n, n)).astype(np.float32)
    return A(m @ m.T + n * np.eye(n, dtype=np.float32), float_case=True)


def _jax(made):
    kind = made[0]
    if kind == "list":
        return [_jax(m) for m in made[1]]
    _, a, dt = made
    return JT(jnp.asarray(a, dt))


def _torch(made):
    kind = made[0]
    if kind == "list":
        return [_torch(m) for m in made[1]]
    _, a, dt = made
    return torch.from_numpy(np.asarray(a)).to(getattr(torch, dt))


def _build(args, rng, dt):
    """(reference args, port args) from specs; other values as they are."""
    ref, port = [], []
    for a in args:
        if isinstance(a, list) and any(hasattr(i, "make") for i in a):
            a = L(*a)
        if hasattr(a, "make"):
            made = a.make(rng, dt)
            ref.append(_jax(made))
            port.append(_torch(made))
        else:
            ref.append(a)
            port.append(a)
    return ref, port


# -- comparison ---------------------------------------------------------------

def _ref_np(v):
    v = v._value if isinstance(v, JT) else v
    a = np.asarray(v)
    name = str(a.dtype)
    if name == "bfloat16":
        a = a.astype(np.float32)
    return a, name


def _port_np(v):
    name = str(v.dtype).split(".")[-1]
    t = v.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.numpy(), NARROW.get(name, name)


def _close(got, want, tol, where):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)), (where, type(got))
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, tol, "%s[%d]" % (where, i))
        return
    if not isinstance(want, (JT, np.ndarray)) and not hasattr(
            want, "dtype"):
        g = got.item() if isinstance(got, torch.Tensor) else got
        assert g == want, (where, got, want)
        return
    w, wname = _ref_np(want)
    g, gname = _port_np(got)
    assert gname == wname, (where, "dtype", gname, wname)
    assert g.shape == w.shape, (where, "shape", g.shape, w.shape)
    if tol is None or not np.issubdtype(w.dtype, np.inexact):
        np.testing.assert_array_equal(g, w, err_msg=where)
    else:
        np.testing.assert_allclose(g, w, equal_nan=True, err_msg=where,
                                   **tol)


def _fn(mod_ref, mod_port, name):
    if "." in name:
        sub, name = name.split(".")
        return (getattr(getattr(mod_ref, sub), name),
                getattr(getattr(mod_port, sub), name))
    return getattr(mod_ref, name), getattr(mod_port, name)


# -- the cases ------------------------------------------------------------------

def C(name, args, kw=None, fam="f", dtypes=("float32",), case=None):
    return (case or name, name, args, kw or {}, fam, dtypes)


X = F(3, 4)
Y = F(3, 4)
POS = F(3, 4, lo=0.2, hi=3.0)
UNIT = F(3, 4, lo=-0.9, hi=0.9)
INT = I(3, 4, lo=1, hi=20)
INT2 = I(3, 4, lo=1, hi=20)
MAT = F(4, 4)

CREATION = [
    C("to_tensor", [[[1, 2], [3, 4]]], fam="x", case="to_tensor_ints"),
    C("to_tensor", [np.array([1.5, 2.5])], fam="x", case="to_tensor_f64"),
    C("to_tensor", [[1.0, 2.0]], dict(dtype="float16"), fam="x",
      case="to_tensor_dtype"),
    C("zeros", [[2, 3]], fam="x"), C("ones", [[2, 3], "int32"], fam="x"),
    C("full", [[2, 2], 3.5], fam="x"), C("empty", [[2]], fam="x"),
    C("zeros_like", [X], fam="x", dtypes=HALF),
    C("ones_like", [X, "float16"], fam="x"),
    C("full_like", [X, 2.0], fam="x"), C("empty_like", [INT], fam="x"),
    C("arange", [5], fam="x", case="arange_int"),
    C("arange", [1.0, 3.0, 0.5], fam="x", case="arange_float"),
    C("linspace", [0.0, 1.0, 5]), C("logspace", [0.0, 2.0, 3], fam="t"),
    C("eye", [3, 4], fam="x"), C("diag", [F(4)], fam="x", case="diag_vec"),
    C("diag", [MAT, 1], fam="x", case="diag_mat"),
    C("diag", [F(3), 0, 9.0], fam="x", case="diag_pad"),
    C("diagflat", [F(2, 2), 1], fam="x"),
    C("tril", [MAT, -1], fam="x", dtypes=HALF),
    C("triu", [MAT, 1], fam="x", dtypes=HALF),
    C("meshgrid", [F(3), F(2)], fam="x"), C("assign", [X], fam="x"),
    C("clone", [X], fam="x", dtypes=HALF), C("numel", [X], fam="x"),
]

UNARY = [("abs", X, "x"), ("neg", X, "x"), ("exp", X, "t"),
         ("expm1", X, "t"), ("log", POS, "t"), ("log2", POS, "t"),
         ("log10", POS, "t"), ("log1p", POS, "t"), ("sqrt", POS, "t"),
         ("rsqrt", POS, "t"), ("square", X, "f"), ("sin", X, "t"),
         ("cos", X, "t"), ("tan", UNIT, "t"), ("asin", UNIT, "t"),
         ("acos", UNIT, "t"), ("atan", X, "t"), ("sinh", X, "t"),
         ("cosh", X, "t"), ("tanh", X, "t"), ("asinh", X, "t"),
         ("acosh", F(3, 4, lo=1.1, hi=3.0), "t"), ("atanh", UNIT, "t"),
         ("floor", X, "x"), ("ceil", X, "x"), ("round", X, "x"),
         ("trunc", X, "x"), ("frac", X, "f"), ("sign", X, "x"),
         ("reciprocal", POS, "f"), ("erf", X, "t"), ("erfinv", UNIT, "t"),
         ("lgamma", POS, "t"), ("digamma", POS, "t"),
         ("rad2deg", X, "f"), ("deg2rad", X, "f"), ("angle", X, "x"),
         ("conj", X, "x"), ("real", X, "x"), ("imag", X, "x")]
UNARY_HALF = {"abs", "neg", "exp", "log", "sqrt", "rsqrt", "square", "sin",
              "cos", "tanh", "floor", "ceil", "round", "sign", "reciprocal",
              "erf"}
MATH = [C(n, [s], fam=fam, dtypes=HALF if n in UNARY_HALF else
          ("float32",)) for n, s, fam in UNARY] + [
    C("math.i0", [X], fam="t"), C("math.sigmoid", [X], fam="t",
                                  dtypes=HALF),
    C("exp", [INT], fam="t", case="exp_int"),
    C("abs", [I(3, 4, lo=-5, hi=5)], fam="x", case="abs_int"),
]
BINARY = [("add", "f"), ("subtract", "f"), ("multiply", "f"),
          ("divide", "f"), ("maximum", "x"), ("minimum", "x"),
          ("fmax", "x"), ("fmin", "x"), ("atan2", "t"),
          ("heaviside", "x"), ("math.nextafter", "x"), ("hypot", "t"),
          ("math.copysign", "x"), ("logaddexp", "t")]
MATH += [C(n, [X, Y], fam=fam, dtypes=HALF if n in (
    "add", "subtract", "multiply", "divide", "maximum", "minimum")
    else ("float32",)) for n, fam in BINARY]
MATH += [
    C("add", [X, 2.0], case="add_scalar", dtypes=HALF),
    C("add", [INT, X], case="add_int_float"),
    C("add", [F(3, 1), F(1, 4)], case="add_broadcast"),
    C("multiply", [INT, INT2], fam="x", case="multiply_int"),
    C("divide", [INT, INT2], case="divide_int"),
    C("floor_divide", [X, F(3, 4, lo=0.5, hi=2.0)], fam="x"),
    C("floor_divide", [I(3, 4, lo=-9, hi=9), INT2], fam="x",
      case="floor_divide_int"),
    C("remainder", [X, F(3, 4, lo=0.5, hi=2.0)]),
    C("remainder", [I(3, 4, lo=-9, hi=9), INT2], fam="x",
      case="remainder_int"),
    C("mod", [X, F(3, 4, lo=0.5, hi=2.0)]),
    C("floor_mod", [I(3, 4, lo=-9, hi=9), INT2], fam="x"),
    C("pow", [POS, Y], fam="t"), C("pow", [X, 2], case="pow_scalar",
                                   dtypes=HALF),
    C("pow", [INT, 2], fam="x", case="pow_int"),
    C("gcd", [INT, INT2], fam="x"), C("lcm", [INT, INT2], fam="x"),
    C("scale", [X, 2.0, 1.0], dtypes=HALF),
    C("scale", [X, 2.0, 1.0, False], case="scale_bias_first"),
    C("clip", [X, -0.5, 0.5], fam="x", dtypes=HALF),
    C("clip", [X, None, 0.5], fam="x", case="clip_max"),
    C("lerp", [X, Y, 0.3]), C("stanh", [X], fam="t"),
    C("logit", [F(3, 4, lo=0.05, hi=0.95)], fam="t"),
    C("logit", [F(3, 4, lo=0.0, hi=1.0), 0.01], fam="t", case="logit_eps"),
    C("math.multiply_add", [X, Y, F(3, 4)]),
    C("addmm", [F(3, 5), F(3, 4), F(4, 5), 0.5, 2.0], fam="l"),
    C("matmul", [F(3, 4), F(4, 5)], fam="l", dtypes=HALF),
    C("matmul", [F(2, 4, 3), F(2, 5, 4), True, True], fam="l",
      case="matmul_transposed"),
    C("matmul", [F(4), F(4, 5)], fam="l", case="matmul_vec"),
    C("dot", [F(2, 4), F(2, 4)], fam="l"), C("mm", [MAT, F(4, 3)], fam="l"),
    C("bmm", [F(2, 3, 4), F(2, 4, 2)], fam="l"),
    C("mv", [MAT, F(4)], fam="l"), C("inner", [F(2, 4), F(3, 4)], fam="l"),
    C("outer", [F(3), F(2, 2)], fam="f"), C("kron", [F(2, 2), F(2, 3)]),
    C("cross", [F(4, 3), F(4, 3)]),
    C("cross", [F(3, 4), F(3, 4), 0], case="cross_axis"),
    C("trace", [MAT, 1]), C("trace", [F(2, 3, 4), 0, 1, 2],
                             case="trace_axes"),
    C("diagonal", [F(2, 3, 4), 1, 1, 2], fam="x"),
    C("cumsum", [X], dtypes=HALF), C("cumsum", [X, 1], case="cumsum_axis"),
    C("cumsum", [INT, 0], fam="x", case="cumsum_int"),
    C("cumprod", [F(3, 4, lo=0.5, hi=1.5), 1]),
    C("cumprod", [F(2, 3, lo=0.5, hi=1.5)], case="cumprod_flat"),
    C("math.cummax_values", [X, 1], fam="x"),
    C("math.cummin_values", [X, 0], fam="x"),
    C("nan_to_num", [A([np.nan, np.inf, -np.inf, 1.5], True)], fam="x"),
    C("nan_to_num", [A([np.nan, np.inf, -np.inf], True), 1.0, 9.0, -9.0],
      fam="x", case="nan_to_num_values"),
    C("isnan", [A([np.nan, 1.0, np.inf], True)], fam="x", dtypes=HALF),
    C("isinf", [A([np.nan, 1.0, -np.inf], True)], fam="x"),
    C("isfinite", [A([np.nan, 1.0, np.inf], True)], fam="x"),
    C("increment", [X, 2.0]),
    C("cast", [X, "int32"], fam="x", case="cast_int"),
    C("cast", [X, "float16"], fam="x", case="cast_half"),
    C("cast", [INT, "bool"], fam="x", case="cast_bool"),
    C("logcumsumexp", [X, 1], fam="t"),
    C("logcumsumexp", [X, 0], fam="t", dtypes=("float16",),
      case="logcumsumexp_f16"),
    C("dist", [X, Y]), C("dist", [X, Y, float("inf")], case="dist_inf"),
    C("dist", [X, Y, 0], case="dist_0"),
    C("dist", [X, Y, 1.5], fam="t", case="dist_p"),
    C("renorm", [X, 2.0, 0, 1.0], fam="t"),
    C("mode", [I(3, 7, lo=0, hi=3), 1], fam="x"),
    C("mode", [A([[1.0, 2.0, 2.0, 1.0], [3.0, 3.0, 0.0, 0.0]], True), -1,
               True], fam="x", case="mode_ties_keepdim"),
    C("nanmedian", [A([[1.0, np.nan, 3.0, 2.0], [np.nan] * 4], True), 1]),
    C("nanmedian", [A([1.0, np.nan, 5.0, 2.0], True)], case="nanmedian_all"),
    C("squared_l2_norm", [X]), C("clip_by_norm", [X, 1.0]),
    C("add_n", [L(X, Y, F(3, 4))]),
    C("math.identity_loss", [X, "mean"]),
    C("math.identity_loss", [X, "sum"], case="identity_loss_sum"),
]

REDUCTION = []
for _n in ("sum", "mean", "prod", "max", "min", "amax", "amin", "nansum",
           "nanmean", "logsumexp"):
    fam = "t" if _n == "logsumexp" else ("x" if _n in (
        "max", "min", "amax", "amin") else "f")
    src = F(2, 3, 4, lo=0.5, hi=1.5) if _n == "prod" else F(2, 3, 4)
    REDUCTION += [C(_n, [src], fam=fam, dtypes=HALF if _n in (
        "sum", "mean", "max", "amax") else ("float32",)),
        C(_n, [src, 1, True], fam=fam, case=_n + "_axis_keepdim"),
        C(_n, [src, [0, 2]], fam=fam, case=_n + "_axes")]
REDUCTION += [
    C("sum", [INT], fam="x", case="sum_int"),
    C("sum", [X, 1, False, "float16"], fam="x", case="sum_dtype"),
    C("sum", [B(3, 4), 0], fam="x", case="sum_bool"),
    C("mean", [INT], case="mean_int"),
    C("prod", [I(2, 3, lo=1, hi=4), 1], fam="x", case="prod_int"),
    C("all", [B(3, 4)], fam="x"), C("all", [INT, 1], fam="x",
                                    case="all_int_axis"),
    C("any", [B(3, 4), 0, True], fam="x"),
    C("std", [F(3, 5)]), C("std", [F(3, 5), 1, False, True],
                           case="std_biased"),
    C("var", [F(3, 5), [0, 1]]), C("var", [F(3, 5), 0, False],
                                   case="var_biased"),
    C("median", [F(3, 5)]), C("median", [F(3, 4), 1],
                              case="median_even_axis"),
    C("median", [F(2, 3, 4), [0, 2], True], case="median_axes_keepdim"),
    C("quantile", [F(3, 5), [0.1, 0.5, 0.9], 1]),
    C("quantile", [F(2, 3, 4), 0.3, [0, 2], True], case="quantile_keepdim"),
    C("argmax", [X], fam="x", dtypes=HALF), C("argmax", [X, 1, True],
                                             fam="x", case="argmax_axis"),
    C("argmin", [X, 0, False, "int32"], fam="x"),
    C("argmin", [X, None, True], fam="x", case="argmin_flat_keepdim"),
    C("count_nonzero", [I(3, 4, lo=0, hi=2), 1, True], fam="x"),
    C("count_nonzero", [I(3, 4, lo=0, hi=2)], fam="x",
      case="count_nonzero_all"),
]

COMPARISON = [C(n, [X, Y if n != "equal" else X], fam="x",
                dtypes=HALF if n in ("equal", "less_than") else ("float32",))
              for n in ("equal", "not_equal", "greater_than",
                        "greater_equal", "less_than", "less_equal")]
COMPARISON += [C(n, [B(3, 4), B(3, 4)], fam="x")
               for n in ("logical_and", "logical_or", "logical_xor")]
COMPARISON += [C(n, [INT, INT2], fam="x")
               for n in ("bitwise_and", "bitwise_or", "bitwise_xor")]
COMPARISON += [
    C("equal", [INT, 3], fam="x", case="equal_scalar"),
    C("logical_not", [B(3, 4)], fam="x"),
    C("logical_and", [INT, X], fam="x", case="logical_and_numbers"),
    C("bitwise_not", [I(3, 4, lo=-5, hi=5)], fam="x"),
    C("bitwise_and", [B(3, 4), B(3, 4)], fam="x", case="bitwise_and_bool"),
    C("isclose", [X, A(np.zeros((3, 4)), True), 1e-5, 2.0], fam="x"),
    C("allclose", [X, X], fam="x"), C("equal_all", [INT, INT], fam="x"),
    C("equal_all", [INT, I(3, 5)], fam="x", case="equal_all_shapes"),
    C("is_empty", [F(0, 3)], fam="x"),
    C("comparison.in1d", [INT, I(4, lo=0, hi=10)], fam="x"),
]

IDX = I(2, 3, lo=0, hi=3)
MANIPULATION = [
    C("reshape", [F(2, 6), [3, -1]], fam="x", dtypes=HALF),
    C("transpose", [F(2, 3, 4), [2, 0, 1]], fam="x", dtypes=HALF),
    C("t", [F(2, 3)], fam="x"), C("t", [F(3)], fam="x", case="t_vec"),
    C("concat", [L(F(2, 3), F(4, 3)), 0], fam="x", dtypes=HALF),
    C("stack", [L(X, Y), 1], fam="x"),
    C("split", [F(6, 2), 3], fam="x"),
    C("split", [F(2, 7), [2, -1, 1], 1], fam="x", case="split_sections"),
    C("chunk", [F(4, 2), 2], fam="x"), C("unbind", [F(2, 3), 1], fam="x"),
    C("squeeze", [F(1, 3, 1)], fam="x"),
    C("squeeze", [F(1, 3, 1), [0, 1]], fam="x", case="squeeze_axes"),
    C("unsqueeze", [F(2, 3), [0, -1]], fam="x"),
    C("flatten", [F(2, 3, 4), 1, 2], fam="x"),
    C("tile", [F(2, 3), [2, 1, 2]], fam="x"),
    C("expand", [F(3, 1), [2, -1, 4]], fam="x"),
    C("expand_as", [F(3, 1), F(3, 4)], fam="x"),
    C("broadcast_to", [F(1, 4), [3, 4]], fam="x"),
    C("broadcast_tensors", [[F(3, 1), F(1, 4)]], fam="x"),
    C("flip", [X, [0, 1]], fam="x"), C("roll", [X, 2], fam="x"),
    C("roll", [X, [1, -1], [0, 1]], fam="x", case="roll_axes"),
    C("rot90", [X, 1, [0, 1]], fam="x"),
    C("gather", [F(4, 3), I(5, lo=0, hi=4)], fam="x", dtypes=HALF),
    C("gather", [F(4, 3), IDX, 1], fam="x", case="gather_2d_index"),
    C("index_select", [F(4, 3), I(2, lo=0, hi=3), 1], fam="x"),
    C("gather_nd", [F(3, 4, 2), I(5, 2, lo=0, hi=3)], fam="x"),
    C("take_along_axis", [X, I(3, 2, lo=0, hi=4), 1], fam="x"),
    C("put_along_axis", [X, A([[0], [2], [1]]), 9.0, 1], fam="x"),
    C("put_along_axis", [X, A([[0, 0], [2, 1], [1, 3]]), F(3, 2), 1,
                         "add"], fam="f", case="put_along_axis_add"),
    C("put_along_axis", [X, A([[0], [2], [1]]), F(3, 1), 1, "mul"],
      fam="f", case="put_along_axis_mul"),
    C("scatter", [F(4, 3), A([2, 0]), F(2, 3)], fam="x"),
    C("scatter", [F(4, 3), A([2, 0, 2]), F(3, 3), False], fam="f",
      case="scatter_accumulate"),
    C("scatter_nd_add", [F(4, 3), A([[1], [3], [1]]), F(3, 3)]),
    C("scatter_nd", [A([[1], [3]]), F(2, 3), [5, 3]], fam="x"),
    C("where", [B(3, 4), X, Y], fam="x", dtypes=HALF),
    C("where", [B(3, 4), X, 0.0], fam="x", case="where_scalar"),
    C("masked_fill", [X, B(3, 4), -1.0], fam="x", dtypes=HALF),
    C("masked_select", [X, B(3, 4)], fam="x"),
    C("nonzero", [I(3, 4, lo=0, hi=2)], fam="x"),
    C("nonzero", [I(3, 4, lo=0, hi=2), True], fam="x",
      case="nonzero_tuple"),
    C("unique", [I(10, lo=0, hi=5)], fam="x"),
    C("unique", [I(10, lo=0, hi=5), True, False, True], fam="x",
      case="unique_index_counts"),
    C("unique", [A([[1, 2], [1, 2], [0, 3]]), False, False, True, 0],
      fam="x", case="unique_axis"),
    C("sort", [X, 1], fam="x", dtypes=HALF),
    C("sort", [X, 0, True], fam="x", case="sort_descending"),
    C("argsort", [I(3, 6, lo=0, hi=3), 1], fam="x"),
    C("argsort", [I(3, 6, lo=0, hi=3), 1, True], fam="x",
      case="argsort_descending_ties"),
    C("topk", [X, 2], fam="x"),
    C("topk", [X, 2, 0, False], fam="x", case="topk_smallest"),
    C("kthvalue", [I(3, 6, lo=0, hi=4), 2, 1], fam="x"),
    C("kthvalue", [X, 1, 0, True], fam="x", case="kthvalue_keepdim"),
    C("slice", [F(3, 4, 5), [0, 2], [1, -3], [3, 5]], fam="x"),
    C("strided_slice", [F(4, 6), [0, 1], [3, 5], [0, 0], [-2, -2]],
      fam="x"),
    C("strided_slice", [F(4, 6), [1], [0], [6], [2]], fam="x",
      case="strided_slice_fwd"),
    C("pad", [F(2, 3), [1, 2, 0, 1]], fam="x"),
    C("pad", [F(1, 2, 4), [2, 1], "reflect"], fam="x", case="pad_reflect"),
    C("repeat_interleave", [X, 2, 1], fam="x"),
    C("repeat_interleave", [F(3), A([1, 0, 2])], fam="x",
      case="repeat_interleave_list"),
    C("moveaxis", [F(2, 3, 4), 0, 2], fam="x"),
    C("swapaxes", [F(2, 3, 4), 0, 2], fam="x"),
    C("searchsorted", [A([1.0, 3.0, 5.0, 7.0], True), F(5, lo=0, hi=8)],
      fam="x"),
    C("searchsorted", [A([1, 3, 5]), A([3, 4]), True, True], fam="x",
      case="searchsorted_right"),
    C("bucketize", [F(5, lo=0, hi=8), A([1.0, 3.0, 5.0], True)], fam="x"),
    C("one_hot", [I(5, lo=0, hi=4), 4], fam="x"),
    C("index_add", [F(4, 3), A([0, 2, 0]), 0, F(3, 3)]),
    C("index_put", [F(4, 3), [A([0, 2]), A([1, 1])], 5.0], fam="x"),
    C("index_put", [F(4, 3), [A([0, 0])], F(2, 3), True],
      case="index_put_accumulate"),
    C("as_strided", [F(12), [3, 2], [4, 1], 1], fam="x"),
    C("diff", [X], fam="f"), C("diff", [X, 2, 0], case="diff_n"),
    C("unfold", [F(1, 2, 5, 5), [2, 3], [1, 2], [1, 0]], fam="x"),
    C("unstack", [F(2, 3), 1], fam="x"), C("reverse", [X, 0], fam="x"),
    C("manipulation.fill", [X, 3.0], fam="x"),
    C("fill_diagonal", [F(3, 4), 7.0, 1], fam="x"),
    C("fill_diagonal", [F(5, 2), 7.0, 0, True], fam="x",
      case="fill_diagonal_wrap"),
    C("fill_diagonal", [F(3, 3, 3), 7.0], fam="x", case="fill_diagonal_3d"),
    C("diag_embed", [F(2, 3), 1], fam="x"),
    C("multiplex", [[F(3, 2), F(3, 2)], A([[1], [0], [1]])], fam="x"),
    C("index_sample", [F(3, 5), I(3, 2, lo=0, hi=5)], fam="x"),
    C("unique_consecutive", [A([1, 1, 2, 2, 2, 3, 1]), True, True],
      fam="x"),
    C("unique_consecutive", [A([[1, 2], [1, 2], [3, 4]]), False, True, 0],
      fam="x", case="unique_consecutive_axis"),
    C("fill_diagonal_tensor", [F(3, 4), F(3), 1], fam="x"),
]

LINALG = [
    C("linalg.norm", [X], fam="l"), C("linalg.norm", [X, "fro", 1, True],
                                      fam="l", case="norm_axis"),
    C("linalg.norm", [X, "fro", [0, 1]], fam="l", case="norm_matrix"),
    C("linalg.norm", [MAT, "nuc"], fam="l", case="norm_nuc"),
    C("linalg.norm", [X, float("inf"), 1], fam="l", case="norm_inf"),
    C("linalg.norm", [X, 0], fam="l", case="norm_0"),
    C("linalg.norm", [X, 3, 0], fam="l", case="norm_p"),
    C("cholesky", [spd(4)], fam="l"),
    C("cholesky", [spd(3), True], fam="l", case="cholesky_upper"),
    C("linalg.inv", [spd(4)], fam="l"), C("linalg.pinv", [F(4, 3)], fam="l"),
    C("linalg.det", [spd(3)], fam="l"), C("linalg.slogdet", [MAT], fam="l"),
    C("linalg.solve", [spd(4), F(4, 2)], fam="l"),
    C("linalg.triangular_solve", [spd(4), F(4, 2)], fam="l"),
    C("linalg.triangular_solve", [spd(4), F(4, 2), False, True, True],
      fam="l", case="triangular_solve_flags"),
    C("linalg.cholesky_solve", [F(3, 2), A(np.linalg.cholesky(
        spd(3).value), True)], fam="l"),
    C("linalg.matrix_power", [F(3, 3, lo=-0.5, hi=0.5), 3], fam="l"),
    C("linalg.matrix_power", [spd(3), -1], fam="l",
      case="matrix_power_inverse"),
    C("linalg.matrix_rank", [A(np.outer(np.arange(4.0), np.ones(3)),
                               True)], fam="x"),
    C("linalg.eigvalsh", [spd(4)], fam="l"),
    C("linalg.lstsq", [F(5, 3), F(5, 2)], fam="l"),
    C("linalg.multi_dot", [[F(2, 3), F(3, 4), F(4, 2)]], fam="l"),
    C("histogram", [F(20), 5], fam="x"),
    C("histogram", [F(20), 4, -1.0, 1.0], fam="x", case="histogram_range"),
    C("bincount", [I(12, lo=0, hi=5)], fam="x"),
    C("bincount", [I(6, lo=0, hi=3), F(6), 5], case="bincount_weights"),
    C("corrcoef", [F(3, 6)], fam="l"),
    C("cov", [F(3, 6)], fam="l"), C("cov", [F(6, 3), False, False],
                                    fam="l", case="cov_cols"),
    C("tensordot", [F(2, 3, 4), F(3, 4, 2)], fam="l"),
    C("tensordot", [F(2, 3), F(3, 2), [[1], [0]]], fam="l",
      case="tensordot_axes"),
    C("einsum", ["bij,bjk->bik", F(2, 3, 4), F(2, 4, 2)], fam="l",
      dtypes=HALF),
]

EXTRAS = [
    C("as_complex", [F(3, 2)], fam="x"),
    C("as_real", [F(3, 2)], fam="x", case="as_real_of_real"),
    C("complex", [X, Y], fam="x"), C("sgn", [X], fam="x"),
    C("broadcast_shape", [[3, 1], [1, 4]], fam="x"),
    C("frexp", [X], fam="x"),
    C("nanquantile", [A([[1.0, np.nan, 3.0], [2.0, 4.0, np.nan]], True),
                      0.5, 1]),
    C("take", [X, I(5, lo=-12, hi=12)], fam="x"),
    C("take", [X, I(5, lo=-30, hi=30), "wrap"], fam="x", case="take_wrap"),
    C("take", [X, I(5, lo=-30, hi=30), "clip"], fam="x", case="take_clip"),
    C("tril_indices", [4, 3, -1], fam="x"),
    C("triu_indices", [3, None, 1], fam="x"),
    C("vsplit", [F(4, 2), 2], fam="x"),
    C("shard_index", [I(6, 1, lo=0, hi=20), 20, 2, 1], fam="x"),
    C("shape", [F(2, 3)], fam="x"), C("rank", [F(2, 3)], fam="x"),
    C("is_complex", [X], fam="x"), C("is_floating_point", [X], fam="x"),
    C("is_integer", [INT], fam="x"), C("is_integer", [X], fam="x",
                                       case="is_integer_float"),
    C("tolist", [INT], fam="x"), C("check_shape", [[2, -1, 3]], fam="x"),
    C("crop", [F(4, 5), [2, -1], [1, 2]], fam="x"),
    C("gcd", [I(4, lo=-9, hi=9), I(4, lo=1, hi=9)], fam="x",
      case="gcd_negative"),
    C("angle", [A([1.0, -1.0, 0.0], True)], fam="x", case="angle_signs"),
    C("imag", [X], fam="x", case="imag_real"),
]

ATTRIBUTE = [C("attribute." + n, [X], fam="x") for n in
             ("rank", "shape", "is_complex", "is_floating_point",
              "is_integer", "real", "imag")]

CASES = (CREATION + MATH + REDUCTION + COMPARISON + MANIPULATION + LINALG
         + EXTRAS + ATTRIBUTE)
PARAMS = [pytest.param(c, dt, id="%s-%s" % (c[0], dt))
          for c in CASES for dt in c[5]]


class _Mods:
    """``paddle`` / ``paddle_tpu_torch`` with the op modules and
    ``attribute`` reachable by name."""

    def __init__(self, top, ops, attr):
        self.top, self.ops, self.attr = top, ops, attr

    def __getattr__(self, name):
        if name == "attribute":
            return self.attr
        if hasattr(self.top, name) and name not in (
                "math", "linalg", "manipulation", "comparison", "extras",
                "creation", "reduction"):
            return getattr(self.top, name)
        return getattr(self.ops, name)


REF = _Mods(paddle, jops, jattr)
PORT = _Mods(pt, tops, tattr)


@pytest.mark.parametrize("case,dt", PARAMS)
def test_op_matches_the_reference(case, dt):
    cid, name, args, kw, fam, _ = case
    rng = np.random.default_rng(zlib.crc32(cid.encode()))
    ref_args, port_args = _build(args, rng, dt)
    ref_fn, port_fn = _fn(REF, PORT, name)
    want = ref_fn(*ref_args, **kw)
    got = port_fn(*port_args, **kw)
    if fam == "x":
        tol = None
    elif dt in HALF_TOLS:
        tol = HALF_TOLS[dt]
    else:
        tol = TOLS[fam]
    _close(got, want, tol, cid)


# -- decompositions: values and reconstructions -----------------------------------

def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _j(a):
    return JT(jnp.asarray(a, jnp.float32))


def test_svd_qr_eigh_eig_lu():
    rng = np.random.default_rng(7)
    a = rng.standard_normal((5, 3)).astype(np.float32)
    s = spd(4).value
    tol = TOLS["l"]
    u, sv, vh = pt.linalg.svd(_t(a))
    _, jsv, _ = paddle.linalg.svd(_j(a))
    np.testing.assert_allclose(sv.numpy(), np.asarray(jsv._value), **tol)
    np.testing.assert_allclose((u * sv @ vh).numpy(), a, **tol)
    q, r = pt.linalg.qr(_t(a))
    jq, jr = paddle.linalg.qr(_j(a))
    np.testing.assert_allclose(np.abs(r.numpy()), np.abs(np.asarray(
        jr._value)), **tol)
    np.testing.assert_allclose((q @ r).numpy(), a, **tol)
    w, v = pt.linalg.eigh(_t(s))
    jw, _ = paddle.linalg.eigh(_j(s))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw._value), **tol)
    np.testing.assert_allclose((v * w @ v.T).numpy(), s, rtol=1e-4,
                               atol=1e-3)
    g = rng.standard_normal((4, 4)).astype(np.float32)
    ew, ev = pt.linalg.eig(_t(g))
    jew, _ = paddle.linalg.eig(_j(g))
    np.testing.assert_allclose(np.sort_complex(ew.numpy()),
                               np.sort_complex(np.asarray(jew._value)),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose((ev @ torch.diag(ew) @ torch.linalg.inv(ev))
                               .real.numpy(), g, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(
        np.sort_complex(pt.linalg.eigvals(_t(g)).numpy()),
        np.sort_complex(np.asarray(paddle.linalg.eigvals(_j(g))._value)),
        rtol=1e-4, atol=1e-4)
    lu, piv = pt.linalg.lu(_t(g))
    jlu, jpiv = paddle.linalg.lu(_j(g))
    np.testing.assert_array_equal(piv.numpy(), np.asarray(jpiv._value))
    np.testing.assert_allclose(lu.numpy(), np.asarray(jlu._value), **tol)
    p, lo, up = pt.linalg.lu_unpack(lu, piv)
    jp, jlo, jup = paddle.linalg.lu_unpack(jlu, jpiv)
    for got, want in ((p, jp), (lo, jlo), (up, jup)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want._value),
                                   **tol)
    np.testing.assert_allclose((p @ lo @ up).numpy(), g, rtol=1e-4,
                               atol=1e-4)
    lu3, piv3, info = pt.linalg.lu(_t(g), get_infos=True)
    assert info.dtype == torch.int32 and int(info) == 0


# -- random ops: shape, dtype, range -------------------------------------------

RANDOM = [("rand", [[2, 3]], {}, (0.0, 1.0)),
          ("randn", [[2, 3]], {}, None),
          ("standard_normal", [[4]], {}, None),
          ("normal", [1.0, 0.5, [3, 2]], {}, None),
          ("uniform", [[5], "float32", -3.0, -1.0], {}, (-3.0, -1.0)),
          ("randint", [2, 7, [4, 3]], {}, (2, 6)),
          ("randperm", [6], {}, (0, 5))]


@pytest.mark.parametrize("name,args,kw,span", RANDOM,
                         ids=[r[0] for r in RANDOM])
def test_random_op_shape_dtype_range(name, args, kw, span):
    want = getattr(paddle, name)(*args, **kw)
    got = getattr(pt, name)(*args, **kw)
    w, wname = _ref_np(want)
    g, gname = _port_np(got)
    assert (g.shape, gname) == (w.shape, wname)
    if span is not None:
        assert g.min() >= span[0] and g.max() <= span[1]


def test_random_ops_of_a_tensor():
    probs = np.array([[0.1, 0.0, 0.9], [0.5, 0.5, 0.0]], np.float32)
    m = pt.multinomial(_t(probs), 2)
    jm = paddle.multinomial(_j(probs), 2)
    assert m.shape == tuple(jm.shape) and m.dtype == torch.int64
    assert not (m == 1)[0].any() and not (m == 2)[1].any()
    b = pt.bernoulli(_t(probs))
    assert b.dtype == torch.float32 and set(b.unique().tolist()) <= {0., 1.}
    assert torch.equal(b[probs == 0], torch.zeros(int((probs == 0).sum())))
    r = pt.randint_like(_t(probs), 3, 5)
    assert r.dtype == torch.float32 and set(r.unique().tolist()) <= {3., 4.}
    p = pt.poisson(torch.full((1000,), 4.0))
    assert p.dtype == torch.float32 and abs(float(p.mean()) - 4.0) < 0.3


# -- methods, in-place forms, indexing ------------------------------------------

METHOD_ARGS = {"clip": (-0.5, 0.5), "scale": (2.0,), "cast": ("float16",),
               "astype": ("int32",), "lerp": ("Y", 0.5),
               "reshape": ([4, 3],), "transpose": ([1, 0],),
               "squeeze": (), "unsqueeze": (0,), "flatten": (),
               "tile": ([1, 2],), "expand": ([2, 3, 4],),
               "expand_as": ("Y",), "broadcast_to": ([2, 3, 4],),
               "flip": (0,), "roll": (1,), "gather": ("IDX",),
               "index_select": ("IDX",), "gather_nd": ("IDX2",),
               "masked_select": ("MASK",), "masked_fill": ("MASK", 0.0),
               "scatter": ("IDX", "ROWS"), "scatter_nd_add": ("IDX2",
                                                              "ROW"),
               "take_along_axis": ("IDXA", 1),
               "put_along_axis": ("IDXA", 1.0, 1), "topk": (2,),
               "split": (2, 1), "chunk": (2, 1), "unbind": (0,),
               "where": ("X", "Y"), "trace": (), "diagonal": (),
               "tril": (), "triu": (), "norm": (), "__pow__": (2,),
               "__rpow__": (2,), "__getitem__": ((slice(1, 3), 0),),
               "pow": (2,)}
BINARY_METHODS = {"__add__", "__radd__", "__sub__", "__rsub__", "__mul__",
                  "__rmul__", "__truediv__", "__rtruediv__", "__floordiv__",
                  "__rfloordiv__", "__mod__", "__rmod__", "__eq__",
                  "__ne__", "__lt__", "__le__", "__gt__", "__ge__", "add",
                  "subtract", "multiply", "divide", "maximum", "minimum",
                  "equal", "not_equal", "greater_than", "greater_equal",
                  "less_than", "less_equal", "isclose", "allclose",
                  "equal_all", "dot"}
INT_METHODS = {"bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
               "__invert__", "logical_and", "logical_or", "logical_xor",
               "logical_not", "nonzero", "unique"}
SQUARE = {"__matmul__", "__rmatmul__", "matmul", "mm", "cholesky",
          "inverse", "bmm"}
METHOD_NAMES = [n for n, f in jops._METHODS.items()
                if f is not None and n not in ("__setitem__", "numel")]


def _method_inputs(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    x = rng.uniform(0.5, 2.0, (3, 4)).astype(np.float32)
    if name in SQUARE:
        x = spd(3).value
        if name == "bmm":
            x = x[None]
    if name in INT_METHODS:
        x = rng.integers(0, 4, (3, 4)).astype(np.int32)
    extra = {"X": x, "Y": np.full_like(x, 1.5), "IDX": np.array([0, 2]),
             "IDX2": np.array([[0, 1], [2, 3]]),
             "IDXA": np.array([[0], [2], [1]]), "MASK": x > 1.0,
             "ROWS": np.ones((2, 4), np.float32),
             "ROW": np.ones(2, np.float32)}
    args = METHOD_ARGS.get(name, ("Y",) if name in BINARY_METHODS
                           or name in SQUARE - {"cholesky", "inverse"}
                           or name in {"bitwise_and", "bitwise_or",
                                       "bitwise_xor", "logical_and",
                                       "logical_or", "logical_xor"}
                           else ())
    if name in SQUARE - {"cholesky", "inverse"}:
        extra["Y"] = x
    elif name in INT_METHODS:
        extra["Y"] = rng.integers(0, 4, (3, 4)).astype(np.int32)
    if name == "where":
        extra["X"] = x > 1.0
    ref = [_j(extra[a]) if isinstance(a, str) and a in extra and
           extra[a].dtype == np.float32 else
           JT(jnp.asarray(extra[a])) if isinstance(a, str) and a in extra
           else a for a in args]
    port = [torch.from_numpy(np.asarray(extra[a])) if isinstance(a, str)
            and a in extra else a for a in args]
    if name == "where":
        return JT(jnp.asarray(x > 1.0)), torch.from_numpy(x > 1.0), \
            [_j(x), _j(x * 2)], [_t(x), _t(x * 2)]
    return (JT(jnp.asarray(x)), torch.from_numpy(x), ref, port)


@pytest.mark.parametrize("name", METHOD_NAMES)
def test_method_table_matches_the_reference(name):
    jx, tx, ref_args, port_args = _method_inputs(name)
    want = getattr(jx, name)(*ref_args)
    got = tops.method(name)(tx, *port_args)
    _close(got, want, TOLS["l"], name)


@pytest.mark.parametrize("base", tops.INPLACE_BASES)
def test_inplace_forms(base):
    x = np.random.default_rng(1).uniform(0.5, 2.0, (3, 4)).astype(
        np.float32)
    args = {"add": (1.0,), "subtract": (1.0,), "multiply": (2.0,),
            "divide": (2.0,), "clip": (0.7, 1.2), "scale": (3.0,),
            "reshape": ([4, 3],), "squeeze": (), "unsqueeze": (0,),
            "flatten": (), "cast": ("float16",)}.get(base, ())
    jx = JT(jnp.asarray(x))
    tx = torch.from_numpy(x.copy())
    out = tops.method(base + "_")(tx, *args)
    getattr(jx, base + "_")(*args)
    assert out is tx
    _close(tx, jx, TOLS["t"], base + "_")


def test_setitem_and_getitem_mask():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    jx = JT(jnp.asarray(x))
    tx = torch.from_numpy(x.copy())
    jx[1, 2:] = 5.0
    assert tops.setitem(tx, (1, slice(2, None)), 5.0) is tx
    _close(tx, jx, None, "setitem")
    mask = x > 6
    _close(tops.getitem(tx, torch.from_numpy(mask)),
           jx[JT(jnp.asarray(mask))], None, "getitem mask")
    _close(tops.getitem(tx, [0, 2]), jx[[0, 2]], None, "getitem list")
    _close(pt.reshape_(tx, [4, 3]), jx.reshape([4, 3]), None, "reshape_")
    assert tx.shape == (4, 3)


def test_c_ops_surface():
    from paddle_tpu_torch import _C_ops

    assert _C_ops.add is WRAPPERS["add"]
    assert _C_ops.rope_apply.op_name == "rope_apply"
    with pytest.raises(AttributeError, match="A.10"):
        _C_ops.fft
    with pytest.raises(AttributeError, match="no op 'no_such_op'"):
        _C_ops.no_such_op


# -- the op-coverage gate -------------------------------------------------------------

def test_op_coverage_gate():
    """Every op of the reference's inventory is ported (a primitive of its
    name) or waits for a ROADMAP item that ROADMAP.md names."""
    coverage.load_all()
    text = (ROOT / "paddle_tpu" / "ops" / "ops.yaml").read_text()
    names = re.findall(r"^- op : (\S+)$", text, re.M)
    assert len(names) == 375
    unaccounted = [n for n in names
                   if n not in WRAPPERS and n not in coverage.WAITING]
    assert not unaccounted, unaccounted
    stale = sorted(n for n in coverage.WAITING if n in WRAPPERS)
    assert not stale, stale
    assert set(coverage.WAITING) <= set(names)
    roadmap = (ROOT / "ROADMAP.md").read_text()
    for item in set(coverage.WAITING.values()):
        assert re.search(r"^%s\. \*\*" % re.escape(item.split(".")[1]),
                         roadmap, re.M), item


def test_every_reference_op_module_function_has_a_counterpart():
    """Each public function of the reference's op modules and
    ``tensor/attribute.py`` has one of its name in the port's module."""
    for mod in ("creation", "math", "manipulation", "reduction",
                "comparison", "linalg", "extras"):
        ref = getattr(jops, mod)
        port = getattr(tops, mod)
        for name, obj in vars(ref).items():
            if callable(obj) and not name.startswith("_") and getattr(
                    obj, "__module__", "").startswith("paddle_tpu.ops"):
                assert hasattr(port, name), (mod, name)
    for name in jattr.__all__:
        assert hasattr(tattr, name), name


# -- faults of the reference ----------------------------------------------------

def test_x64_narrowing_is_a_fault_of_the_reference():
    """"Faults of the reference" 21: without JAX's x64 the reference
    narrows int64 and float64 to 32 bits; the port keeps int64, and turns
    float64 data into the default float dtype as Paddle does."""
    ints = np.array([1, 2, 3], np.int64)
    assert str(paddle.to_tensor(ints).dtype) == "int32"
    assert str(paddle.arange(5).dtype) == "int32"
    assert pt.to_tensor(ints).dtype == torch.int64
    assert pt.arange(5).dtype == torch.int64
    assert pt.to_tensor(np.array([1.5])).dtype == torch.float32
    assert pt.to_tensor([1.5], dtype="float64").dtype == torch.float64
    assert str(paddle.to_tensor([1.5], dtype="float64").dtype) == "float32"


@pytest.mark.parametrize("call,ref_call", [
    (lambda: pt.scale(torch.ones(2), 2.0, act="relu"),
     lambda: paddle.scale(_j(np.ones(2)), 2.0, act="relu")),
    (lambda: pt.cumsum(torch.ones(2), dtype="float16"),
     lambda: paddle.cumsum(_j(np.ones(2)), dtype="float16")),
    (lambda: pt.cumprod(torch.ones(2), dtype="float16"),
     lambda: paddle.cumprod(_j(np.ones(2)), dtype="float16")),
    (lambda: pt.linalg.matrix_rank(torch.eye(2), hermitian=True),
     lambda: paddle.linalg.matrix_rank(_j(np.eye(2)), hermitian=True)),
], ids=["scale_act", "cumsum_dtype", "cumprod_dtype",
        "matrix_rank_hermitian"])
def test_arguments_the_reference_ignores_raise(call, ref_call):
    """"Faults of the reference" 22: the reference accepts these and
    applies none (its result is float32 / unchanged); the port raises."""
    out = ref_call()
    assert str(out.dtype) in ("float32", "int32")
    with pytest.raises(NotImplementedError, match="Faults of the "
                       "reference\" 22"):
        call()
