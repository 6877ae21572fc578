"""Gradient clipping (counterpart of paddle_tpu/optimizer/clip.py).

A clip object is called on ``[(param, grad)]`` pairs and returns new
pairs with the clipped gradients; the optimizer calls it in ``step()``
before the update. The math is the reference's: norms are taken in
float32, the scale is ``min(clip_norm / max(norm, 1e-12), 1)``, the
gradient is scaled in float32 (a bf16 gradient times the reference's
float32 scale promotes to float32) and cast back to its dtype.
Plain tensor work: the reference leaves it to XLA, the port to PyTorch.
"""
from __future__ import annotations

import torch


class ClipGradBase:
    def __call__(self, params_grads):
        """``[(param, grad)] -> [(param, clipped grad)]``."""
        grads = self.clip_grads([g for _, g in params_grads])
        return [(p, g) for (p, _), g in zip(params_grads, grads)]

    def clip_grads(self, grads):
        """The clipped form of a list of gradient tensors."""
        raise NotImplementedError


def _scale(clip_norm, norm):
    return torch.clamp(clip_norm / torch.clamp(norm, min=1e-12), max=1.0)


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def clip_grads(self, grads):
        return [torch.clamp(g, self.min, self.max) for g in grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient clipped by its own L2 norm."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def clip_grads(self, grads):
        out = []
        for g in grads:
            norm = torch.sqrt(torch.sum(torch.square(g.float())))
            out.append((g.float() * _scale(self.clip_norm, norm)).to(g.dtype))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """All gradients scaled by one factor from their joint L2 norm."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = clip_norm

    def global_norm(self, grads):
        """The float32 L2 norm over every gradient, as a 0-d tensor."""
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in grads))

    def clip_grads(self, grads):
        if not grads:
            return []
        scale = _scale(self.clip_norm, self.global_norm(grads))
        return [(g.float() * scale).to(g.dtype) for g in grads]
