"""Tensor property queries (counterpart of paddle_tpu/tensor/attribute.py)."""
from __future__ import annotations

import torch

from ..ops.math import _tensor

__all__ = ["rank", "shape", "is_complex", "is_floating_point",
           "is_integer", "real", "imag"]


def rank(input):
    x = _tensor(input)
    return torch.tensor(x.dim(), device=x.device)


def shape(input):
    return list(_tensor(input).shape)


def is_complex(x):
    return _tensor(x).is_complex()


def is_floating_point(x):
    return _tensor(x).is_floating_point()


def is_integer(x):
    x = _tensor(x)
    return not (x.is_floating_point() or x.is_complex()
                or x.dtype == torch.bool)


def real(x):
    x = _tensor(x)
    return x.real if x.is_complex() else x


def imag(x):
    x = _tensor(x)
    return x.imag if x.is_complex() else torch.zeros_like(x)
