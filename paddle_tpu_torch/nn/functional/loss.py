"""Loss functionals (counterpart of paddle_tpu/nn/functional/loss.py).

``cross_entropy`` ports the reference's hot-path branch, the decoder LM
loss: hard labels, softmax over the last axis, no class weights and no
label smoothing. The logits are upcast to float32, the per-row loss is
``logsumexp - picked``, and rows whose label is ``ignore_index`` give 0.
The soft-label, weighted and label-smoothing branches are not ported
yet.
"""
from __future__ import annotations

import torch

_REDUCTIONS = ("mean", "sum", "none")


def cross_entropy(input, label, ignore_index=-100, reduction="mean"):
    """``input [..., C]`` logits, ``label [...]`` (or ``[..., 1]``) class
    ids. ``mean`` divides the summed loss by ``max(#valid rows, 1)`` and
    stays float32; ``sum`` and ``none`` return ``input``'s dtype."""
    if reduction not in _REDUCTIONS:
        raise ValueError("reduction must be one of %s, got %r"
                         % (_REDUCTIONS, reduction))
    n_cls = input.shape[-1]
    li = label.long()
    if li.dim() == input.dim() and li.shape[-1] == 1:
        li = li.squeeze(-1)
    xf = input.float()
    lse = torch.logsumexp(xf, dim=-1)
    picked = xf.gather(-1, li.clamp(0, n_cls - 1).unsqueeze(-1)).squeeze(-1)
    valid = li != ignore_index
    loss = torch.where(valid, lse - picked, torch.zeros_like(lse))
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp(min=1).to(loss.dtype)
    if reduction == "sum":
        loss = loss.sum()
    return loss.to(input.dtype)
