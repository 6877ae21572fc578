"""Tensor creation and the random family (counterpart of
paddle_tpu/ops/creation.py).

A creation op places its result on the current place (``core.place
.get_device()``: the card unless ``set_device`` says otherwise) or on the
``place`` it is given; the ``*_like`` ops follow their input. A float
result without a dtype takes the default dtype
(``core.dtype.get_default_dtype``). ``to_tensor`` keeps int64 data int64
and, like Paddle, turns float64 data into the default float dtype when no
dtype is asked for (the reference, without JAX's x64, also narrows int64
to int32: "Faults of the reference" 21 in ROADMAP.md).

The random ops draw from ``framework.random``'s generator for their
device, so ``seed`` fixes them; their streams are PyTorch's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as _dtype
from ..core.dispatch import primitive
from ..core.place import current_torch_device
from ..framework import random as _random


def _device(place=None):
    return current_torch_device(place)


def _resolve(dtype, default=None):
    if dtype is None and default is not None:
        return _dtype.to_torch(default)
    return _dtype.to_torch(dtype)


def _item(x):
    return x.item() if isinstance(x, torch.Tensor) else x


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """``data`` (a number, a nested list, a numpy array or a tensor) as a
    new tensor; ``stop_gradient=False`` makes it require a gradient."""
    if isinstance(data, torch.Tensor):
        out = data.detach()
        dev = out.device if place is None else _device(place)
        out = out.to(dev, None if dtype is None else _dtype.to_torch(dtype),
                     copy=True)
    else:
        arr = np.asarray(data)
        if dtype is not None:
            target = _dtype.to_torch(dtype)
        elif arr.dtype == np.float64:
            target = _dtype.to_torch(None)
        elif arr.dtype == np.complex128:
            target = torch.complex64
        else:
            target = None
        out = torch.as_tensor(arr, device=_device(place))
        if target is not None:
            out = out.to(target)
    if not stop_gradient:
        out.requires_grad_(True)
    return out


def _shape_list(shape):
    if isinstance(shape, torch.Tensor):
        return [int(s) for s in shape.tolist()]
    if isinstance(shape, (int, np.integer)):
        return [int(shape)]
    return [int(_item(s)) for s in shape]


def zeros(shape, dtype=None, place=None):
    return torch.zeros(_shape_list(shape), dtype=_resolve(
        dtype, _dtype.get_default_dtype()), device=_device(place))


def ones(shape, dtype=None, place=None):
    return torch.ones(_shape_list(shape), dtype=_resolve(
        dtype, _dtype.get_default_dtype()), device=_device(place))


def full(shape, fill_value, dtype=None, place=None):
    return torch.full(_shape_list(shape), _item(fill_value),
                      dtype=_resolve(dtype, _dtype.get_default_dtype()),
                      device=_device(place))


def empty(shape, dtype=None, place=None):
    return zeros(shape, dtype, place)


def _like(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x), device=_device())


def zeros_like(x, dtype=None):
    return torch.zeros_like(_like(x), dtype=None if dtype is None
                            else _dtype.to_torch(dtype))


def ones_like(x, dtype=None):
    return torch.ones_like(_like(x), dtype=None if dtype is None
                           else _dtype.to_torch(dtype))


def full_like(x, fill_value, dtype=None):
    return torch.full_like(_like(x), _item(fill_value),
                           dtype=None if dtype is None
                           else _dtype.to_torch(dtype))


def empty_like(x, dtype=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, place=None):
    start, end, step = _item(start), _item(end), _item(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = ("int64" if all(isinstance(v, (int, np.integer))
                                for v in (start, end, step))
                 else _dtype.get_default_dtype())
    return torch.arange(start, end, step, dtype=_dtype.to_torch(dtype),
                        device=_device(place))


def linspace(start, stop, num, dtype=None, place=None):
    return torch.linspace(_item(start), _item(stop), int(_item(num)),
                          dtype=_resolve(dtype, _dtype.get_default_dtype()),
                          device=_device(place))


def logspace(start, stop, num, base=10.0, dtype=None, place=None):
    return torch.logspace(_item(start), _item(stop), int(_item(num)),
                          base=base, dtype=_resolve(
                              dtype, _dtype.get_default_dtype()),
                          device=_device(place))


def eye(num_rows, num_columns=None, dtype=None, place=None):
    n = int(num_rows)
    m = n if num_columns is None else int(num_columns)
    return torch.eye(n, m, dtype=_resolve(dtype, _dtype.get_default_dtype()),
                     device=_device(place))


def diag(x, offset=0, padding_value=0):
    x = _like(x)
    if x.dim() == 1 and padding_value != 0:
        d = torch.diag(x, offset)
        mask = torch.diag(torch.ones_like(x, dtype=torch.bool), offset)
        return torch.where(mask, d, torch.full_like(d, padding_value))
    return torch.diag(x, offset)


def diagflat(x, offset=0):
    return torch.diagflat(_like(x), offset)


@primitive(name="tril")
def _tril(x, diagonal=0):
    return torch.tril(x, diagonal)


@primitive(name="triu")
def _triu(x, diagonal=0):
    return torch.triu(x, diagonal)


def tril(x, diagonal=0):
    return _tril(x, diagonal=diagonal)


def triu(x, diagonal=0):
    return _triu(x, diagonal=diagonal)


def meshgrid(*args):
    ts = list(args[0]) if len(args) == 1 and isinstance(
        args[0], (list, tuple)) else list(args)
    return list(torch.meshgrid(*[_like(t) for t in ts], indexing="ij"))


def assign(x, output=None):
    v = x.detach().clone() if isinstance(x, torch.Tensor) else \
        torch.as_tensor(np.asarray(x), device=_device())
    if output is not None:
        with torch.no_grad():
            output.copy_(v)
        return output
    return v


@primitive(name="clone")
def _clone(x):
    return x.clone()


def clone(x):
    return _clone(x)


def numel(x):
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


# -- random family -------------------------------------------------------

def rand(shape, dtype=None, place=None):
    return uniform(shape, dtype=dtype, min=0.0, max=1.0, place=place)


def randn(shape, dtype=None, place=None):
    dev = _device(place)
    return torch.randn(_shape_list(shape), generator=_random.generator(dev),
                       dtype=_resolve(dtype, _dtype.get_default_dtype()),
                       device=dev)


def standard_normal(shape, dtype=None, place=None):
    return randn(shape, dtype, place)


def normal(mean=0.0, std=1.0, shape=None, name=None, place=None):
    v = randn([] if shape is None else shape, place=place)
    return v * std + mean


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, place=None):
    """Uniform in ``[min, max)``; a nonzero ``seed`` draws from a generator
    of its own seeded with it."""
    dev = _device(place)
    gen = (_random.generator(dev) if not seed else
           torch.Generator(device=dev).manual_seed(int(seed)))
    out = torch.empty(_shape_list(shape), dtype=_resolve(
        dtype, _dtype.get_default_dtype()), device=dev)
    return out.uniform_(min, max, generator=gen)


def randint(low=0, high=None, shape=(1,), dtype=None, place=None):
    if high is None:
        low, high = 0, low
    dev = _device(place)
    return torch.randint(int(low), int(high), _shape_list(shape),
                         generator=_random.generator(dev),
                         dtype=_resolve(dtype, "int64"), device=dev)


def randperm(n, dtype=None, place=None):
    dev = _device(place)
    return torch.randperm(int(n), generator=_random.generator(dev),
                          dtype=_resolve(dtype, "int64"), device=dev)


def multinomial(x, num_samples=1, replacement=False):
    x = _like(x)
    return torch.multinomial(x.float(), int(num_samples), replacement,
                             generator=_random.generator(x.device))


def bernoulli(x):
    x = _like(x)
    return torch.bernoulli(x, generator=_random.generator(x.device))
