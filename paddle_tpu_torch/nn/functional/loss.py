"""Loss functionals (counterpart of paddle_tpu/nn/functional/loss.py).

``cross_entropy`` keeps the reference's two paths. The hot path (hard
labels, softmax, no class weights, no label smoothing: the decoder LM
loss) upcasts the logits to float32, takes ``logsumexp - picked`` per
row and gives 0 to rows labelled ``ignore_index``; ``mean`` stays float32
and divides by ``max(#valid rows, 1)``, ``sum``/``none`` return the
input's dtype. Every other branch goes through log-probabilities in the
input's dtype (``log_softmax``, or ``log(max(x, 1e-30))`` when
``use_softmax=False``), with the reference's quirks:

- soft labels: ``-sum(label * logp)`` per row, and ``mean`` is a plain
  mean over rows (``ignore_index`` and ``weight`` do not apply);
- label smoothing: the row's target is ``onehot * (1 - eps) + eps / C``
  (an out-of-range label, such as ``ignore_index``, has an all-zero
  one-hot), and ignored rows are zeroed afterwards;
- class weights: each row's loss is scaled by ``weight[label]`` (0 for
  ignored rows), and ``mean`` divides by the sum of those weights, with
  a floor of 1e-12;
- labels of shape ``[..., 1]`` (1 on ``axis``) are squeezed.

``softmax_with_cross_entropy`` and ``nll_loss`` follow the reference's
functions of the same names. All plain PyTorch: the reference has no
Pallas kernel here.
"""
from __future__ import annotations

import torch

_REDUCTIONS = ("mean", "sum", "none")


def _check_reduction(reduction):
    if reduction not in _REDUCTIONS:
        raise ValueError("reduction must be one of %s, got %r"
                         % (_REDUCTIONS, reduction))


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def _hard_labels(label, x, axis):
    li = torch.as_tensor(label, device=x.device).long()
    if li.dim() == x.dim() and li.shape[axis] == 1:
        li = li.squeeze(axis)
    return li


def _pick(values, li, axis, n_cls):
    """``values`` at the (clipped) class ``li`` along ``axis``."""
    idx = li.clamp(0, n_cls - 1).unsqueeze(axis)
    return values.gather(axis, idx).squeeze(axis)


def _class_weights(weight, li, valid, n_cls):
    """``weight[label]`` per row (0 for ignored rows), in the weight's
    dtype, so a bfloat16 loss times float32 weights is float32, as in the
    reference."""
    w = torch.as_tensor(weight, device=li.device)[li.clamp(0, n_cls - 1)]
    return torch.where(valid, w, torch.zeros_like(w))


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """``input [..., C, ...]`` scores with the classes on ``axis``;
    ``label`` class ids (``[...]`` or 1 on ``axis``) or, with
    ``soft_label``, a distribution of ``input``'s shape."""
    _check_reduction(reduction)
    x = input
    axis = axis % x.dim()
    n_cls = x.shape[axis]
    if (use_softmax and not soft_label and weight is None
            and label_smoothing == 0.0):
        li = _hard_labels(label, x, axis)
        xf = x.float()
        lse = torch.logsumexp(xf, dim=axis)
        valid = li != ignore_index
        loss = torch.where(valid, lse - _pick(xf, li, axis, n_cls),
                           torch.zeros_like(lse))
        if reduction == "mean":
            return loss.sum() / valid.sum().clamp(min=1).to(loss.dtype)
        return _reduce(loss, reduction).to(x.dtype)
    if use_softmax:
        logp = torch.log_softmax(x, dim=axis)
    else:
        logp = torch.log(x.clamp(min=1e-30))
    if soft_label:
        soft = torch.as_tensor(label, device=x.device).to(logp.dtype)
        return _reduce(-(soft * logp).sum(axis), reduction)
    li = _hard_labels(label, x, axis)
    if label_smoothing > 0.0:
        classes = torch.arange(n_cls, device=x.device).view(
            [n_cls if d == axis else 1 for d in range(x.dim())])
        onehot = (li.unsqueeze(axis) == classes).to(logp.dtype)
        soft = onehot * (1.0 - label_smoothing) + label_smoothing / n_cls
        loss = -(soft * logp).sum(axis)
    else:
        loss = -_pick(logp, li, axis, n_cls)
    valid = li != ignore_index
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if weight is not None:
        w = _class_weights(weight, li, valid, n_cls)
        loss = loss * w
        if reduction == "mean":
            return loss.sum() / w.sum().clamp(min=1e-12)
    if reduction == "mean":
        return loss.sum() / valid.sum().to(loss.dtype).clamp(min=1.0)
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False, axis=-1,
                               ignore_index=-100, return_softmax=False):
    """Per-row loss with the class axis kept (size 1), and the softmax
    beside it when ``return_softmax``."""
    loss = cross_entropy(logits, label, soft_label=soft_label, axis=axis,
                         ignore_index=ignore_index, reduction="none")
    loss = loss.unsqueeze(axis)
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100,
             reduction="mean"):
    """``input`` log-probabilities ``[C]``, ``[N, C]`` or
    ``[N, C, d1, ...]`` (classes on axis 1), ``label`` ``[N, d1, ...]``."""
    _check_reduction(reduction)
    logp = input
    li = torch.as_tensor(label, device=logp.device).long()
    n_cls = logp.shape[-1] if logp.dim() == 1 else logp.shape[1]
    if logp.dim() > 2:
        logp = logp.movedim(1, -1)        # [N, C, d1..] -> [N, d1.., C]
    loss = -_pick(logp, li, -1, n_cls)
    valid = li != ignore_index
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if weight is not None:
        w = _class_weights(weight, li, valid, n_cls)
        loss = loss * w
        if reduction == "mean":
            return loss.sum() / w.sum().clamp(min=1e-12)
    if reduction == "mean":
        return loss.sum() / valid.sum().to(loss.dtype).clamp(min=1.0)
    return _reduce(loss, reduction)
