"""Device places (counterpart of paddle_tpu/core/place.py).

``Place`` and its kinds, each resolving to a ``torch.device``:
``CPUPlace`` to the CPU, ``CUDAPlace(i)`` to card ``i``,
``CUDAPinnedPlace`` to page-locked host memory (the CPU device; creation
ops pin what they make there). ``set_device`` / ``get_device`` keep the
current place; with none set, ``get_device()`` is the card
(``device.resolve_device``), which raises without one.

The reference's accelerator is the TPU: there ``CUDAPlace`` and the
vendor aliases map to it, ``is_compiled_with_cuda()`` is False and
``is_compiled_with_tpu()`` True. The port answers for itself: True and
False (a deliberate difference, ROADMAP.md A.5). ``TPUPlace``,
``NPUPlace`` and the custom-device registry (PJRT plugins) have no
counterpart on this stack and raise ``UnimplementedError``.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from .enforce import UnimplementedError

_NO_PLACE = ("%s has no counterpart in the PyTorch/CUDA port: its devices "
             "are the CPU and CUDA cards (ROADMAP.md A.5)")


class Place:
    device_type = "unknown"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def __repr__(self):
        return "Place(%s:%d)" % (self.device_type, self.device_id)

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def torch_device(self) -> torch.device:
        raise UnimplementedError(_NO_PLACE % type(self).__name__)


class CPUPlace(Place):
    device_type = "cpu"

    def __init__(self):
        super().__init__(0)

    def torch_device(self):
        return torch.device("cpu")


class CUDAPlace(Place):
    device_type = "gpu"

    def torch_device(self):
        return resolve_device(torch.device("cuda", self.device_id))


class CUDAPinnedPlace(Place):
    """Page-locked host memory: tensors live on the CPU, pinned."""

    device_type = "cpu"

    def __init__(self):
        super().__init__(0)

    def torch_device(self):
        return torch.device("cpu")


class TPUPlace(Place):
    device_type = "tpu"

    def __init__(self, device_id=0):
        raise UnimplementedError(_NO_PLACE % "TPUPlace")


class NPUPlace(Place):
    device_type = "npu"

    def __init__(self, device_id=0):
        raise UnimplementedError(_NO_PLACE % "NPUPlace")


class CustomPlace(Place):
    def __init__(self, device_type, device_id=0):
        raise UnimplementedError(_NO_PLACE % "CustomPlace")


def register_custom_device(device_type, pjrt_plugin_path=None,
                           options=None):
    raise UnimplementedError(_NO_PLACE % "a custom device (PJRT plugin)")


def get_all_custom_device_type():
    return []


def is_compiled_with_custom_device(device_type):
    return False


def is_compiled_with_cuda():
    return True


def is_compiled_with_tpu():
    return False


def device_count() -> int:
    """The number of CUDA cards."""
    return torch.cuda.device_count()


_current_place = None


def place_for(device, default_idx=0):
    """A device spec -> its ``Place``: a ``Place``, a ``torch.device``, or
    a string ``'cpu'``, ``'gpu[:i]'`` / ``'cuda[:i]'``."""
    if isinstance(device, Place):
        return device
    if isinstance(device, torch.device):
        device = str(device)
    kind, _, idx = str(device).partition(":")
    idx = int(idx) if idx else default_idx
    if kind == "cpu":
        return CPUPlace()
    if kind in ("gpu", "cuda"):
        return CUDAPlace(idx)
    if kind == "tpu":
        return TPUPlace(idx)
    if kind == "npu":
        return NPUPlace(idx)
    raise UnimplementedError(_NO_PLACE % ("device %r" % (device,)))


def set_device(device):
    """Make ``device`` the current place; returns the ``Place``."""
    global _current_place
    place = place_for(device)
    place.torch_device()       # a card asked for must exist
    _current_place = place
    return place


def _get_current_place() -> Place:
    if _current_place is not None:
        return _current_place
    return CUDAPlace(resolve_device().index)


def get_device():
    """The current place as ``'cpu'`` or ``'gpu:i'``; the card unless
    ``set_device`` chose otherwise."""
    p = _get_current_place()
    return "cpu" if p.device_type == "cpu" else "gpu:%d" % p.device_id


def current_torch_device(place=None):
    """The ``torch.device`` of ``place`` (a ``Place``, a ``torch.device``
    or a string), or of the current place when None."""
    if place is None:
        return _get_current_place().torch_device()
    return place_for(place).torch_device()
