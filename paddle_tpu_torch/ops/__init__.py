"""Tensor operations (counterpart of paddle_tpu/ops/): creation, math,
reductions, comparisons, manipulation, linear algebra and the rest of the
``paddle.*`` tensor API, each reference primitive registered under its
name (``core.dispatch``).

Methods and operators. The reference patches its ``Tensor`` with methods
and dunders (``paddle_tpu/ops/__init__.py:77-246``). The port's tensor is
``torch.Tensor`` and is not patched: ``METHODS`` maps each of those names
(dunders, named methods and the in-place ``*_`` forms) to the function of
this package that computes it, called with the tensor first, and
``method(name)`` looks one up. ``getitem`` and ``setitem`` are the
indexing pair: ``getitem`` is the reference's primitive (a boolean mask
selects as ``masked_select``); ``setitem`` writes in place.
"""
from __future__ import annotations

import torch

from ..core.dispatch import primitive
from . import (  # noqa: F401
    comparison, creation, extras, linalg, manipulation, math, reduction)
from .manipulation import diag_embed, one_hot, pad, unfold  # noqa: F401


def _norm_index(idx, like):
    if isinstance(idx, tuple):
        return tuple(_norm_index(i, like) for i in idx)
    if isinstance(idx, list):
        return torch.as_tensor(idx, device=like.device)
    return idx


@primitive(name="getitem")
def _getitem(x, idx):
    return x[idx]


def getitem(x, idx):
    idx = _norm_index(idx, x)
    if isinstance(idx, torch.Tensor) and idx.dtype == torch.bool:
        return manipulation.masked_select(x, idx)
    return _getitem(x, idx)


def setitem(x, idx, value):
    """``x[idx] = value`` in place; returns ``x``."""
    x[_norm_index(idx, x)] = value
    return x


def _swap(fn):
    def swapped(self, other):
        return fn(other, self)
    swapped.__name__ = "r" + getattr(fn, "__name__", "op")
    return swapped


def _numel(x):
    return x.numel()


METHODS = {
    # dunders
    "__add__": math.add,
    "__radd__": _swap(math.add),
    "__sub__": math.subtract,
    "__rsub__": _swap(math.subtract),
    "__mul__": math.multiply,
    "__rmul__": _swap(math.multiply),
    "__truediv__": math.divide,
    "__rtruediv__": _swap(math.divide),
    "__floordiv__": math.floor_divide,
    "__rfloordiv__": _swap(math.floor_divide),
    "__mod__": math.remainder,
    "__rmod__": _swap(math.remainder),
    "__pow__": math.pow_,
    "__rpow__": _swap(math.pow_),
    "__matmul__": math.matmul,
    "__rmatmul__": _swap(math.matmul),
    "__neg__": math.neg,
    "__abs__": math.abs,
    "__invert__": comparison.logical_not,
    "__eq__": comparison.equal,
    "__ne__": comparison.not_equal,
    "__lt__": comparison.less_than,
    "__le__": comparison.less_equal,
    "__gt__": comparison.greater_than,
    "__ge__": comparison.greater_equal,
    "__getitem__": getitem,
    "__setitem__": setitem,
    # named methods
    "add": math.add,
    "subtract": math.subtract,
    "multiply": math.multiply,
    "divide": math.divide,
    "matmul": math.matmul,
    "mm": math.mm,
    "bmm": math.bmm,
    "dot": math.dot,
    "pow": math.pow_,
    "abs": math.abs,
    "exp": math.exp,
    "log": math.log,
    "sqrt": math.sqrt,
    "rsqrt": math.rsqrt,
    "square": math.square,
    "sin": math.sin,
    "cos": math.cos,
    "tanh": math.tanh,
    "sigmoid": math.sigmoid,
    "floor": math.floor,
    "ceil": math.ceil,
    "round": math.round_,
    "sign": math.sign,
    "reciprocal": math.reciprocal,
    "clip": math.clip,
    "scale": math.scale,
    "cast": math.cast,
    "astype": math.cast,
    "erf": math.erf,
    "lerp": math.lerp,
    "cumsum": math.cumsum,
    "cumprod": math.cumprod,
    "isnan": math.isnan,
    "isinf": math.isinf,
    "isfinite": math.isfinite,
    "trace": math.trace,
    "maximum": math.maximum,
    "minimum": math.minimum,
    # reductions
    "sum": reduction.sum,
    "mean": reduction.mean,
    "prod": reduction.prod,
    "max": reduction.max,
    "min": reduction.min,
    "amax": reduction.amax,
    "amin": reduction.amin,
    "std": reduction.std,
    "var": reduction.var,
    "all": reduction.all,
    "any": reduction.any,
    "argmax": reduction.argmax,
    "argmin": reduction.argmin,
    "logsumexp": reduction.logsumexp,
    "median": reduction.median,
    # manipulation
    "reshape": manipulation.reshape,
    "transpose": manipulation.transpose,
    "squeeze": manipulation.squeeze,
    "unsqueeze": manipulation.unsqueeze,
    "flatten": manipulation.flatten,
    "tile": manipulation.tile,
    "expand": manipulation.expand,
    "expand_as": manipulation.expand_as,
    "broadcast_to": manipulation.broadcast_to,
    "flip": manipulation.flip,
    "roll": manipulation.roll,
    "gather": manipulation.gather,
    "gather_nd": manipulation.gather_nd,
    "index_select": manipulation.index_select,
    "masked_select": manipulation.masked_select,
    "masked_fill": manipulation.masked_fill,
    "scatter": manipulation.scatter,
    "scatter_nd_add": manipulation.scatter_nd_add,
    "take_along_axis": manipulation.take_along_axis,
    "put_along_axis": manipulation.put_along_axis,
    "sort": manipulation.sort,
    "argsort": manipulation.argsort,
    "topk": manipulation.topk,
    "split": manipulation.split,
    "chunk": manipulation.chunk,
    "unbind": manipulation.unbind,
    "nonzero": manipulation.nonzero,
    "unique": manipulation.unique,
    "where": manipulation.where,
    # comparison
    "equal": comparison.equal,
    "not_equal": comparison.not_equal,
    "greater_than": comparison.greater_than,
    "greater_equal": comparison.greater_equal,
    "less_than": comparison.less_than,
    "less_equal": comparison.less_equal,
    "logical_and": comparison.logical_and,
    "logical_or": comparison.logical_or,
    "logical_not": comparison.logical_not,
    "logical_xor": comparison.logical_xor,
    "isclose": comparison.isclose,
    "allclose": comparison.allclose,
    "equal_all": comparison.equal_all,
    "bitwise_and": comparison.bitwise_and,
    "bitwise_or": comparison.bitwise_or,
    "bitwise_xor": comparison.bitwise_xor,
    "bitwise_not": comparison.bitwise_not,
    # linalg and the rest
    "norm": linalg.norm,
    "cholesky": linalg.cholesky,
    "inverse": linalg.inv,
    "clone": creation.clone,
    "numel": _numel,
    "tril": creation.tril,
    "triu": creation.triu,
    "diagonal": math.diagonal,
    "conj": math.conj,
    "real": math.real,
    "imag": math.imag,
    "angle": math.angle,
}

# the reference's in-place spellings (trailing underscore)
INPLACE_BASES = (
    "add", "subtract", "multiply", "divide", "clip", "scale", "exp",
    "sqrt", "rsqrt", "reciprocal", "round", "floor", "ceil", "tanh",
    "sigmoid", "reshape", "squeeze", "unsqueeze", "flatten", "cast",
)
for _base in INPLACE_BASES:
    METHODS[_base + "_"] = extras._make_inplace(_base + "_", METHODS[_base])
del _base


def method(name):
    """The function computing ``Tensor.<name>`` (self first)."""
    try:
        return METHODS[name]
    except KeyError:
        raise AttributeError("Tensor has no method %r" % (name,)) from None


__all__ = ["METHODS", "INPLACE_BASES", "comparison", "creation", "extras",
           "getitem", "linalg", "manipulation", "math", "method",
           "reduction", "setitem", "diag_embed", "one_hot", "pad", "unfold"]
