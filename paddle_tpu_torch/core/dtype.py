"""Data types (counterpart of paddle_tpu/core/dtype.py).

The reference's canonical names, aliases and groups, each name mapped to a
``torch.dtype``; ``set_default_dtype`` / ``get_default_dtype``. A dtype
spec is a name, an alias, a ``torch.dtype``, a numpy dtype or anything
``numpy.dtype`` reads.

The reference runs JAX without x64, so there ``int64`` and ``float64``
narrow to 32 bits ("Faults of the reference" 21 in ROADMAP.md). The port
keeps the dtype the caller asked for, as Paddle does.
"""
from __future__ import annotations

import numpy as np
import torch

_DTYPE_TABLE = {
    "bool": torch.bool,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
}
_TORCH_NAMES = {v: k for k, v in _DTYPE_TABLE.items()}

_ALIASES = {
    "float": "float32",
    "double": "float64",
    "half": "float16",
    "int": "int32",
    "long": "int64",
    "bf16": "bfloat16",
    "fp16": "float16",
    "fp32": "float32",
    "fp64": "float64",
}

FLOATING_DTYPES = ("float16", "bfloat16", "float32", "float64")
INTEGER_DTYPES = ("uint8", "int8", "int16", "int32", "int64")
COMPLEX_DTYPES = ("complex64", "complex128")

_default_dtype = "float32"


def set_default_dtype(d):
    """The dtype of float tensors made without one (creation ops, random
    ops, ``to_tensor`` of Python floats); floating dtypes only."""
    global _default_dtype
    name = canonical_name(d)
    if name not in FLOATING_DTYPES:
        raise TypeError(
            "set_default_dtype only supports floating dtypes, got %s" % name)
    _default_dtype = name


def get_default_dtype():
    return _default_dtype


def canonical_name(dtype) -> str:
    """Any dtype spec -> its canonical name (None -> the default)."""
    if dtype is None:
        return _default_dtype
    if isinstance(dtype, torch.dtype):
        if dtype in _TORCH_NAMES:
            return _TORCH_NAMES[dtype]
        raise TypeError("Unknown dtype %r" % (dtype,))
    if isinstance(dtype, str):
        name = _ALIASES.get(dtype, dtype)
        if name in _DTYPE_TABLE:
            return name
        raise TypeError("Unknown dtype %r" % (dtype,))
    try:
        name = np.dtype(dtype).name
    except TypeError:
        name = getattr(dtype, "name", None) or str(dtype)
    name = _ALIASES.get(name, name)
    if name in _DTYPE_TABLE:
        return name
    raise TypeError("Unknown dtype %r" % (dtype,))


def to_torch(dtype):
    """A dtype spec -> its ``torch.dtype``."""
    return _DTYPE_TABLE[canonical_name(dtype)]


def is_floating(dtype) -> bool:
    return canonical_name(dtype) in FLOATING_DTYPES


def is_integer(dtype) -> bool:
    name = canonical_name(dtype)
    return name in INTEGER_DTYPES or name == "bool"


def is_complex(dtype) -> bool:
    return canonical_name(dtype) in COMPLEX_DTYPES
