"""Common functionals (counterpart of paddle_tpu/nn/functional/common.py):
``dropout``."""
from __future__ import annotations

import torch


def dropout(x, p=0.5, training=True, mode="upscale_in_train", seed=None,
            generator=None):
    """The reference's two modes. Outside training, or at ``p == 0``, it
    is the identity, except that ``downscale_in_infer`` scales by
    ``1 - p`` outside training. In training each element is kept with
    probability ``1 - p`` and, in ``upscale_in_train``, scaled by
    ``1 / (1 - p)``; dropped elements are 0.

    The mask is drawn from ``generator`` (a ``torch.Generator`` on
    ``x``'s device), or from a new one seeded with ``seed``; with
    neither, from PyTorch's default generator. The draws differ from the
    reference's JAX stream."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if seed is not None:
        generator = torch.Generator(device=x.device).manual_seed(seed)
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
    return torch.where(keep, x, 0.0).to(x.dtype)
