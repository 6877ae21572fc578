"""Device policy: the card by default, the CPU only when asked for.

A caller that passes no device gets the current CUDA device. Without a
card that is an error: the port never drops quietly to the CPU, where
every kernel wrapper would run its plain PyTorch version instead of the
kernel. The tests pass ``device="cpu"`` to run that plain path on purpose.
"""
from __future__ import annotations

import torch


def resolve_device(device=None):
    """The ``torch.device`` an entry point runs on (CUDA devices carry an
    explicit index, so they compare equal to a tensor's ``.device``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch: no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch path")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("paddle_tpu_torch: device %r requested but "
                               "no CUDA device is available" % (device,))
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError("paddle_tpu_torch runs on 'cuda' or 'cpu', not %r"
                         % (device,))
    return dev
