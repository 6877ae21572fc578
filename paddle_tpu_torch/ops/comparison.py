"""Comparison and logical ops (counterpart of
paddle_tpu/ops/comparison.py). Boolean results; ``bitwise_*`` keep their
integer or bool dtype."""
from __future__ import annotations

import torch

from ..core.dispatch import primitive
from .math import _promoted, _tensor


def _cmp(name, fn):
    def op(x, y):
        return fn(*_promoted(x, y))

    op.__name__ = op.__qualname__ = name
    return primitive(op, name=name, nondiff=True)


equal = _cmp("equal", torch.eq)
not_equal = _cmp("not_equal", torch.ne)
greater_than = _cmp("greater_than", torch.gt)
greater_equal = _cmp("greater_equal", torch.ge)
less_than = _cmp("less_than", torch.lt)
less_equal = _cmp("less_equal", torch.le)
logical_and = _cmp("logical_and", torch.logical_and)
logical_or = _cmp("logical_or", torch.logical_or)
logical_xor = _cmp("logical_xor", torch.logical_xor)
bitwise_and = _cmp("bitwise_and", torch.bitwise_and)
bitwise_or = _cmp("bitwise_or", torch.bitwise_or)
bitwise_xor = _cmp("bitwise_xor", torch.bitwise_xor)


@primitive(nondiff=True)
def logical_not(x):
    return torch.logical_not(_tensor(x))


@primitive(nondiff=True)
def bitwise_not(x):
    return torch.bitwise_not(_tensor(x))


@primitive(nondiff=True)
def isclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False):
    return torch.isclose(*_promoted(x, y), rtol=rtol, atol=atol,
                         equal_nan=equal_nan)


def allclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False):
    from .reduction import all_

    return all_(isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan))


def equal_all(x, y):
    x, y = _tensor(x), _tensor(y, x)
    if x.shape != y.shape:
        return torch.tensor(False, device=x.device)
    return torch.eq(*_promoted(x, y)).all()


@primitive(nondiff=True)
def is_empty(x):
    x = _tensor(x)
    return torch.tensor(x.numel() == 0, device=x.device)


@primitive(nondiff=True)
def in1d(x, test):
    x = _tensor(x)
    return torch.isin(x, _tensor(test, x))
