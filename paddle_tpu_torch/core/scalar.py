"""Scalar / IntArray, the attribute-normalization types (counterpart of
paddle_tpu/core/scalar.py, copied with a torch tensor taken where the
reference takes its Tensor).

A ``Scalar`` holds one typed value and an ``IntArray`` a small int list
(shapes, axes, strides); each accepts a Python value, a numpy value or
array, or a 0/1-d tensor, and exposes the reference's accessors.
"""
from __future__ import annotations

import numpy as np
import torch


def _unwrap(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class Scalar:
    """One typed scalar (reference phi/common/scalar.h Scalar)."""

    def __init__(self, value):
        if isinstance(value, Scalar):
            self._v = value._v
            return
        if isinstance(value, (bool, int, float, complex)):
            self._v = value
            return
        arr = _unwrap(value)
        if arr.size != 1:
            raise ValueError(
                "Scalar takes exactly one element, got shape %s"
                % (arr.shape,))
        self._v = arr.reshape(()).item()

    def to_bool(self):
        return bool(self._v)

    def to_int(self):
        return int(self._v)

    def to_float(self):
        return float(self._v)

    def to_complex(self):
        return complex(self._v)

    @property
    def dtype(self):
        return type(self._v).__name__

    def __eq__(self, other):
        o = other._v if isinstance(other, Scalar) else other
        return self._v == o

    def __hash__(self):
        return hash(self._v)

    def __repr__(self):
        return "Scalar(%r)" % (self._v,)


class IntArray:
    """Small int vector for shapes/axes/indices (reference
    phi/common/int_array.h IntArray)."""

    def __init__(self, value=(), size=None):
        if isinstance(value, IntArray):
            self._v = list(value._v)
        elif size is not None and isinstance(
                value, (int, float, np.integer, np.floating)):
            self._v = [int(value)] * int(size)
        else:
            arr = _unwrap(value)
            if arr.ndim > 1:
                raise ValueError(
                    "IntArray takes a 0/1-d int sequence, got shape %s"
                    % (arr.shape,))
            self._v = [int(x) for x in np.atleast_1d(arr)]

    def get_data(self):
        return list(self._v)

    to_list = get_data

    def size(self):
        return len(self._v)

    def __len__(self):
        return len(self._v)

    def __getitem__(self, i):
        return self._v[i]

    def __iter__(self):
        return iter(self._v)

    def __eq__(self, other):
        if isinstance(other, IntArray):
            return self._v == other._v
        try:
            return self._v == list(other)
        except TypeError:
            return NotImplemented

    def __hash__(self):
        return hash(tuple(self._v))

    def __repr__(self):
        return "IntArray(%r)" % (self._v,)
