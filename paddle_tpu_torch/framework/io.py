"""``save`` / ``load`` (counterpart of paddle_tpu/framework/io.py).

The payload is the reference's: the object pickled (protocol 4) with
every tensor replaced by a ``_TensorPayload`` holding a numpy array and
the dtype's name, a bfloat16 tensor stored as its ``uint16`` bit view
(numpy has no bfloat16); dicts, lists and tuples are walked, anything
else is pickled as it is. So nested state dicts, optimizer states (slots,
the global step, an LR scheduler's state) and a ``GradScaler``'s state
round-trip.

``load`` reads files written by the port or by the reference: a
``paddle_tpu.framework.io._TensorPayload`` unpickles as this module's
class (``_Unpickler.find_class``), so loading never imports the
reference. Tensors land on the card unless the caller passes
``device="cpu"``; ``return_numpy=True`` gives the stored numpy arrays (a
bfloat16 tensor as its ``uint16`` bits, as in the reference). A bfloat16
payload is read back bit for bit; the reference's own ``load`` converts
the ``uint16`` bits to bfloat16 by value ("Faults of the reference" 16 in
ROADMAP.md). Only files this program or the reference wrote should be
loaded: unpickling runs code.

Both functions take the reference's ``**configs`` and accept none: the
reference accepts them and applies none ("Faults of the reference" 17).
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..device import resolve_device

_NUMPY_OF = {torch.float32: np.float32, torch.float64: np.float64,
             torch.float16: np.float16, torch.int64: np.int64,
             torch.int32: np.int32, torch.int16: np.int16,
             torch.int8: np.int8, torch.uint8: np.uint8,
             torch.bool: np.bool_, torch.complex64: np.complex64,
             torch.complex128: np.complex128}
_TORCH_OF = {"bfloat16": torch.bfloat16}
_TORCH_OF.update({np.dtype(n).name: t for t, n in _NUMPY_OF.items()})


class _TensorPayload:
    def __init__(self, array, dtype):
        # bfloat16 has no numpy dtype: stored as its uint16 bits
        self.dtype = dtype
        if dtype == "bfloat16":
            self.array = array.view(np.uint16) if array.dtype != np.uint16 \
                else array
        else:
            self.array = array

    @property
    def _array(self):
        return self.array


def _to_serializable(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:
            return _TensorPayload(t.view(torch.int16).numpy().view(np.uint16),
                                  "bfloat16")
        if t.dtype not in _NUMPY_OF:
            raise TypeError("save: no payload for a %s tensor" % t.dtype)
        return _TensorPayload(t.numpy(), np.dtype(_NUMPY_OF[t.dtype]).name)
    if isinstance(obj, dict):
        return {k: _to_serializable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_to_serializable(v) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def _tensor(payload, device):
    arr = np.asarray(payload.array)
    if payload.dtype == "bfloat16":
        t = torch.from_numpy(arr.astype(np.uint16).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
        want = _TORCH_OF.get(payload.dtype)
        if want is not None and t.dtype != want:
            t = t.to(want)
    return t.to(device)


def _from_serializable(obj, return_numpy, device):
    if isinstance(obj, _TensorPayload):
        return obj.array if return_numpy else _tensor(obj, device)
    if isinstance(obj, dict):
        return {k: _from_serializable(v, return_numpy, device)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_from_serializable(v, return_numpy, device) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


class _Unpickler(pickle.Unpickler):
    """Maps the reference's payload class onto this module's."""

    def find_class(self, module, name):
        if module in ("paddle_tpu.framework.io", __name__) \
                and name == "_TensorPayload":
            return _TensorPayload
        return super().find_class(module, name)


def _no_configs(fn, configs):
    if configs:
        raise NotImplementedError(
            "%s(%s): the reference accepts these and applies none "
            "(\"Faults of the reference\" 17 in ROADMAP.md)"
            % (fn, ", ".join(sorted(configs))))


def save(obj, path, protocol=4, **configs):
    _no_configs("save", configs)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    payload = _to_serializable(obj)
    with open(path, "wb") as f:
        pickle.dump(payload, f, protocol=protocol)


def load(path, return_numpy=False, device=None, **configs):
    _no_configs("load", configs)
    dev = None if return_numpy else resolve_device(device)
    with open(path, "rb") as f:
        payload = _Unpickler(f).load()
    return _from_serializable(payload, return_numpy, dev)
