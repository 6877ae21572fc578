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
functions of the same names, and so does every other loss below
(``mse_loss`` through ``rnnt_loss``), formula for formula: the same
clamps and floors (``1e-12``, ``1e-30``), the CTC and RNN-T recursions in
log space with ``-1e30`` for an impossible state, the reference's
``reduction`` (``mean``, ``sum``, anything else none) and its dtypes
(``sigmoid_focal_loss``, ``margin_cross_entropy``, ``hsigmoid_loss`` and
``rnnt_loss`` compute in float32). The recursions are host loops over
time (and, for RNN-T, labels) of batched tensor ops, as the reference's
are ``lax.scan`` loops. ``class_center_sample`` draws its negatives from
an explicit ``torch.Generator`` (the reference draws from JAX's key
stream, so the draws differ); its ``group`` argument waits for the
distributed port. All plain PyTorch: the reference has no Pallas kernel
here.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ...core.dispatch import primitive
from ...framework import random as _random

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


@primitive
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


@primitive
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


def _t(x, like):
    return torch.as_tensor(x, device=like.device)


@primitive
def mse_loss(input, label, reduction="mean"):
    return _reduce((input - label).square(), reduction)


@primitive
def l1_loss(input, label, reduction="mean"):
    return _reduce((input - label).abs(), reduction)


@primitive
def smooth_l1_loss(input, label, reduction="mean", delta=1.0):
    d = input - label
    ad = d.abs()
    loss = torch.where(ad < delta, 0.5 * d * d / delta, ad - 0.5 * delta)
    return _reduce(loss, reduction)


@primitive
def binary_cross_entropy(input, label, weight=None, reduction="mean"):
    p = input.clamp(1e-12, 1.0 - 1e-12)
    loss = -(label * torch.log(p) + (1.0 - label) * torch.log(1.0 - p))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@primitive
def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None):
    x, y = logit, label
    if pos_weight is not None:
        loss = -(pos_weight * y * TF.logsigmoid(x)
                 + (1.0 - y) * TF.logsigmoid(-x))
    else:
        loss = x.clamp(min=0) - x * y + torch.log1p(torch.exp(-x.abs()))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@primitive
def kl_div(input, label, reduction="mean"):
    loss = label * (torch.log(label.clamp(min=1e-30)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


@primitive
def hinge_embedding_loss(input, label, margin=1.0, reduction="mean"):
    loss = torch.where(label == 1.0, input, (margin - input).clamp(min=0.0))
    return _reduce(loss, reduction)


@primitive
def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean"):
    loss = (-label * (input - other) + margin).clamp(min=0.0)
    return _reduce(loss, reduction)


@primitive
def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean"):
    norms = (torch.linalg.vector_norm(input1, dim=-1)
             * torch.linalg.vector_norm(input2, dim=-1))
    cos = (input1 * input2).sum(-1) / norms.clamp(min=1e-12)
    loss = torch.where(label == 1, 1.0 - cos, (cos - margin).clamp(min=0.0))
    return _reduce(loss, reduction)


def _p_dist(u, v, p, epsilon):
    """``sum(|u - v + epsilon| ** p) ** (1 / p)`` over the last axis."""
    return (u - v + epsilon).abs().pow(p).sum(-1).pow(1.0 / p)


@primitive
def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean"):
    d_ap = _p_dist(input, positive, p, epsilon)
    d_an = _p_dist(input, negative, p, epsilon)
    if swap:
        d_an = torch.minimum(d_an, _p_dist(positive, negative, p, epsilon))
    return _reduce((d_ap - d_an + margin).clamp(min=0.0), reduction)


@primitive
def log_loss(input, label, epsilon=1e-4):
    return (-label * torch.log(input + epsilon)
            - (1.0 - label) * torch.log(1.0 - input + epsilon))


@primitive
def square_error_cost(input, label):
    return (input - label).square()


_NEG = -1e30


@primitive
def ctc_loss_dense(log_probs, labels, input_lengths, label_lengths,
                   blank=0, reduction="mean"):
    """CTC's alpha recursion in log space over ``log_probs [T, N, C]`` and
    ``labels [N, S]``; ``mean`` averages each loss over its label length."""
    lp = log_probs
    lbl = _t(labels, lp).long()
    t_max, n = lp.shape[:2]
    s = lbl.shape[1]
    rows = torch.arange(n, device=lp.device)
    # the extended sequence: blank, l1, blank, l2, ... blank
    ext = torch.full((n, 2 * s + 1), blank, dtype=torch.long,
                     device=lp.device)
    ext[:, 1::2] = lbl
    label_lengths = _t(label_lengths, lp).long()
    neg = torch.full((n, 2 * s + 1), _NEG, dtype=lp.dtype, device=lp.device)
    first = torch.zeros_like(neg, dtype=torch.bool)
    first[:, :2 if s > 0 else 1] = True
    alpha = torch.where(first, lp[0].gather(1, ext), neg)
    skip = torch.cat([torch.ones((n, 2), dtype=torch.bool, device=lp.device),
                      ext[:, 2:] == ext[:, :-2]], 1)
    alphas = [alpha]
    for t in range(1, t_max):
        a1 = torch.cat([neg[:, :1], alpha[:, :-1]], 1)
        a2 = torch.where(skip, neg,
                         torch.cat([neg[:, :2], alpha[:, :-2]], 1))
        m = torch.maximum(torch.maximum(alpha, a1), a2)
        total = torch.where(
            m <= _NEG / 2, neg,
            m + torch.log(torch.exp(alpha - m) + torch.exp(a1 - m)
                          + torch.exp(a2 - m)))
        alpha = total + lp[t].gather(1, ext)
        alphas.append(alpha)
    t_last = (_t(input_lengths, lp).long() - 1).clamp(0, t_max - 1)
    alpha = torch.stack(alphas)[t_last, rows]          # [N, 2S + 1]
    last = 2 * label_lengths
    ll_blank = alpha.gather(1, last[:, None])[:, 0]
    ll_label = alpha.gather(1, (last - 1).clamp(min=0)[:, None])[:, 0]
    m = torch.maximum(ll_blank, ll_label)
    loss = -(m + torch.log(torch.exp(ll_blank - m) + torch.exp(ll_label - m)))
    if reduction == "mean":
        return (loss / label_lengths.clamp(min=1)).mean()
    return _reduce(loss, reduction)


@primitive
def huber_loss(input, label, delta=1.0, reduction="mean"):
    d = input - label
    ad = d.abs()
    loss = torch.where(ad <= delta, 0.5 * d * d, delta * (ad - 0.5 * delta))
    return _reduce(loss, reduction)


def _bce_logits(x, y):
    return x.clamp(min=0) - x * y + torch.log1p(torch.exp(-x.abs()))


@primitive
def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25,
                       gamma=2.0, reduction="sum"):
    x, y = logit.float(), label.float()
    p = torch.sigmoid(x)
    p_t = p * y + (1 - p) * (1 - y)
    a_t = alpha * y + (1 - alpha) * (1 - y)
    loss = a_t * (1 - p_t).pow(gamma) * _bce_logits(x, y)
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


@primitive
def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      normalize=False):
    valid = label != ignore_index
    loss = torch.where(valid, _bce_logits(x.float(), label.float()), 0.0)
    if normalize:
        loss = loss / valid.float().sum().clamp(min=1.0)
    return loss


@primitive
def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, return_softmax=False,
                         reduction="mean"):
    """ArcFace / CosFace: the target's cosine becomes ``cos(margin1 *
    theta + margin2) - margin3``, every logit is scaled by ``scale``."""
    cos_t = logits.float().clamp(-1.0, 1.0)
    li = _t(label, cos_t).long().reshape(-1)
    modified = torch.cos(margin1 * torch.arccos(cos_t) + margin2) - margin3
    target = TF.one_hot(li, cos_t.shape[-1]).bool()
    out = torch.where(target, modified, cos_t) * scale
    loss = torch.logsumexp(out, -1) - (target * out).sum(-1)
    loss = _reduce(loss, reduction)
    if return_softmax:
        return loss, torch.softmax(out, -1)
    return loss


@primitive
def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False):
    """Hierarchical sigmoid: the default tree is the complete binary tree
    whose leaf of class c is node ``c + num_classes`` (internal nodes
    1..num_classes-1 own the rows of ``weight``); a custom tree comes as
    ``path_table`` / ``path_code`` padded with -1. Returns ``[N, 1]``."""
    x = input.float()
    li = _t(label, x).long().reshape(-1)
    w = weight.float()
    b = None if bias is None else bias.float().reshape(-1)
    if path_table is not None:
        table = _t(path_table, x).long()
        code = _t(path_code, x).float()
        valid = table >= 0
        rows = table.clamp(0, w.shape[0] - 1)
    else:
        depth = max(1, math.ceil(math.log2(max(num_classes, 2))) + 1)
        node = li + num_classes
        tables, codes = [], []
        for _ in range(depth):
            tables.append(node // 2)
            codes.append((node % 2).float())
            node = node // 2
        table = torch.stack(tables, 1)
        code = torch.stack(codes, 1)
        valid = table >= 1
        rows = (table - 1).clamp(0, w.shape[0] - 1)
    logits = torch.einsum("nd,nld->nl", x, w[rows])
    if b is not None:
        logits = logits + b[rows]
    return torch.where(valid, _bce_logits(logits, code), 0.0).sum(
        1, keepdim=True)


@primitive(nondiff=True)
def class_center_sample(label, num_classes, num_samples, group=None, *,
                        generator=None):
    """``(remapped_label, sampled_class_indices)``: every positive class
    (sorted) and then ``min(num_samples, num_classes) - #positives``
    other classes drawn without replacement from ``generator`` (sorted),
    on the labels' device, whose generator it must be; each label maps
    to its class's place in the sample."""
    if group is not None:
        raise NotImplementedError(
            "class_center_sample: the group argument waits for the "
            "distributed port (ROADMAP.md, queue A.7)")
    li = torch.as_tensor(label).long().reshape(-1)
    dev = li.device
    pos = torch.unique(li)
    is_pos = torch.zeros(num_classes, dtype=torch.bool, device=dev)
    is_pos[pos] = True
    neg_pool = torch.arange(num_classes, device=dev)[~is_pos]
    n_extra = max(0, min(num_samples, num_classes) - pos.numel())
    order = torch.randperm(neg_pool.numel(), generator=_random.generator_or(
        generator, dev), device=dev)
    extra = torch.sort(neg_pool[order[:n_extra]]).values
    sampled = torch.cat([pos, extra])
    remap = torch.full((num_classes,), -1, dtype=torch.long, device=dev)
    remap[sampled] = torch.arange(sampled.numel(), device=dev)
    return remap[li], sampled


@primitive
def soft_margin_loss(input, label, reduction="mean", name=None):
    z = -label.to(input.dtype) * input
    return _reduce(torch.logaddexp(torch.zeros_like(z), z), reduction)


@primitive
def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean", name=None):
    y = label.to(input.dtype)
    loss = -(y * TF.logsigmoid(input) + (1.0 - y) * TF.logsigmoid(-input))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss.mean(-1), reduction)


@primitive
def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """L2 on the embeddings plus the soft-target cross-entropy of
    ``anchor @ positive.T`` with same-label targets."""
    lab = labels.reshape(-1)
    l2 = (l2_reg * (anchor.square().sum() + positive.square().sum())
          / anchor.shape[0] * 0.25)
    same = (lab[:, None] == lab[None, :]).to(anchor.dtype)
    target = same / same.sum(1, keepdim=True)
    logp = torch.log_softmax(anchor @ positive.T, 1)
    return l2 - (target * logp).sum(1).mean()


@primitive
def dice_loss(input, label, epsilon=1e-5):
    if label.dim() == input.dim() and label.shape[-1] == 1:
        label = label.squeeze(-1)
    onehot = TF.one_hot(label.long(), input.shape[-1]).to(input.dtype)
    dims = tuple(range(1, input.dim()))
    inter = (input * onehot).sum(dims)
    union = input.sum(dims) + onehot.sum(dims)
    return (1.0 - (2.0 * inter + epsilon) / (union + epsilon)).mean()


@primitive
def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean", name=None):
    """``sum_{i != y} max(0, margin - x[y] + x[i]) ** p / C``, the weight
    ``weight[y]`` multiplying inside the power, as in the reference."""
    y = label.long().reshape(-1)
    picked = input.gather(1, y[:, None])
    base = (margin - picked + input).clamp(min=0.0)
    if weight is not None:
        base = base * weight[y][:, None]
    target = TF.one_hot(y, input.shape[1]).bool()
    m = torch.where(target, 0.0, base.pow(p))
    return _reduce(m.sum(1) / input.shape[1], reduction)


@primitive
def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    out = _p_dist(x, y, p, epsilon)
    return out[..., None] if keepdim else out


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    dist = distance_function or pairwise_distance
    d_pos = dist(input, positive)
    d_neg = dist(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, dist(positive, negative))
    return _reduce((d_pos - d_neg + margin).clamp(min=0.0), reduction)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """``ctc_loss_dense``'s per-sample losses (over the input length with
    ``norm_by_times``), then ``reduction`` (``mean`` a plain mean)."""
    loss = ctc_loss_dense(log_probs, labels, input_lengths, label_lengths,
                          blank=blank, reduction="none")
    if norm_by_times:
        loss = loss / _t(input_lengths, loss).float().reshape(-1).clamp(
            min=1.0)
    return _reduce(loss, reduction)


def warpctc(logits, label, logits_length, labels_length, blank=0,
            norm_by_times=False):
    """``ctc_loss`` (reduction none) over ``log_softmax(logits)``."""
    return ctc_loss(torch.log_softmax(logits, -1), label, logits_length,
                    labels_length, blank=blank, reduction="none",
                    norm_by_times=norm_by_times)


@primitive
def rnnt_loss(input, label, input_lengths, label_lengths, blank=0,
              fastemit_lambda=0.0, reduction="mean", name=None):
    """RNN-T's forward variables over ``input [B, T, U + 1, V]`` logits
    and ``label [B, U]``: ``alpha(t, u) = logaddexp(alpha(t - 1, u) +
    blank(t - 1, u), alpha(t, u - 1) + y(t, u - 1))``, the loss ``-(alpha(
    T - 1, U) + blank(T - 1, U))``. A nonzero ``fastemit_lambda`` raises,
    as in the reference."""
    if fastemit_lambda:
        raise NotImplementedError(
            "rnnt_loss: FastEmit regularization (fastemit_lambda != 0) "
            "is not implemented; pass fastemit_lambda=0.0")
    logp = torch.log_softmax(input.float(), -1)
    lbl = _t(label, logp).long()
    t_len = _t(input_lengths, logp).long()
    u_len = _t(label_lengths, logp).long()
    b, t_max, u1 = logp.shape[:3]
    rows = torch.arange(b, device=logp.device)
    blank_lp = logp[..., blank]                               # [B, T, U+1]
    y_lp = logp[:, :, :u1 - 1].gather(
        -1, lbl[:, None, :, None].expand(b, t_max, u1 - 1, 1))[..., 0]
    start = torch.full((b, u1), _NEG, device=logp.device)
    start[:, 0] = 0.0
    alphas, alpha = [], None
    for t in range(t_max):
        base = start if t == 0 else alpha + blank_lp[:, t - 1]
        cols = [base[:, 0]]
        for u in range(1, u1):
            cols.append(torch.logaddexp(base[:, u],
                                        cols[-1] + y_lp[:, t, u - 1]))
        alpha = torch.stack(cols, 1)
        alphas.append(alpha)
    t_last = t_len - 1
    final = torch.stack(alphas, 1)[rows, t_last, u_len]
    nll = -(final + blank_lp[rows, t_last, u_len])
    return _reduce(nll, reduction)
