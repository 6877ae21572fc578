"""Loss layers (counterpart of paddle_tpu/nn/layers/loss.py).

Each layer holds its functional's options and calls it, as the
reference's do. ``HSigmoidLoss`` owns the tree's ``weight [num_classes -
1, feature_size]`` (XavierNormal, drawn from ``generator``: a
``torch.Generator`` on ``device``, seed 0 when omitted) and ``bias``
(zeros; left out when ``bias_attr is False``); ``device`` defaults to the
card and raises without one.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...core.tensor import Parameter
from ...device import resolve_device
from .. import functional as F


class _Loss(nn.Module):
    """A loss layer: ``forward(*inputs)`` is ``fn(*inputs, **options)``."""
    _fn = None

    def __init__(self, **options):
        super().__init__()
        self.options = options

    def forward(self, *inputs):
        return type(self)._fn(*inputs, **self.options)


class CrossEntropyLoss(_Loss):
    _fn = F.cross_entropy

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__(weight=weight, ignore_index=ignore_index,
                         reduction=reduction, soft_label=soft_label,
                         axis=axis, use_softmax=use_softmax,
                         label_smoothing=label_smoothing)


class NLLLoss(_Loss):
    _fn = F.nll_loss

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__(weight=weight, ignore_index=ignore_index,
                         reduction=reduction)


class MSELoss(_Loss):
    _fn = F.mse_loss

    def __init__(self, reduction="mean"):
        super().__init__(reduction=reduction)


class L1Loss(_Loss):
    _fn = F.l1_loss

    def __init__(self, reduction="mean", name=None):
        super().__init__(reduction=reduction)


class BCELoss(_Loss):
    _fn = F.binary_cross_entropy

    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__(weight=weight, reduction=reduction)


class BCEWithLogitsLoss(_Loss):
    _fn = F.binary_cross_entropy_with_logits

    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__(weight=weight, reduction=reduction,
                         pos_weight=pos_weight)


class KLDivLoss(_Loss):
    _fn = F.kl_div

    def __init__(self, reduction="mean"):
        super().__init__(reduction=reduction)


class SmoothL1Loss(_Loss):
    _fn = F.smooth_l1_loss

    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__(reduction=reduction, delta=delta)


class MarginRankingLoss(_Loss):
    _fn = F.margin_ranking_loss

    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__(margin=margin, reduction=reduction)


class CosineEmbeddingLoss(_Loss):
    _fn = F.cosine_embedding_loss

    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__(margin=margin, reduction=reduction)


class TripletMarginLoss(_Loss):
    _fn = F.triplet_margin_loss

    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__(margin=margin, p=p, epsilon=epsilon, swap=swap,
                         reduction=reduction)


class HingeEmbeddingLoss(_Loss):
    _fn = F.hinge_embedding_loss

    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__(margin=margin, reduction=reduction)


class CTCLoss(_Loss):
    """``ctc_loss_dense``, as the reference's layer calls it."""
    _fn = F.ctc_loss_dense

    def __init__(self, blank=0, reduction="mean"):
        super().__init__(blank=blank, reduction=reduction)


class SoftMarginLoss(_Loss):
    _fn = F.soft_margin_loss

    def __init__(self, reduction="mean", name=None):
        super().__init__(reduction=reduction)


class MultiLabelSoftMarginLoss(_Loss):
    _fn = F.multi_label_soft_margin_loss

    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__(weight=weight, reduction=reduction)


class MultiMarginLoss(_Loss):
    _fn = F.multi_margin_loss

    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean",
                 name=None):
        super().__init__(p=p, margin=margin, weight=weight,
                         reduction=reduction)


class PairwiseDistance(_Loss):
    _fn = F.pairwise_distance

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__(p=p, epsilon=epsilon, keepdim=keepdim)


class TripletMarginWithDistanceLoss(_Loss):
    _fn = F.triplet_margin_with_distance_loss

    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean", name=None):
        super().__init__(distance_function=distance_function, margin=margin,
                         swap=swap, reduction=reduction)


class RNNTLoss(_Loss):
    _fn = F.rnnt_loss

    def __init__(self, blank=0, fastemit_lambda=0.0, reduction="mean",
                 name=None):
        super().__init__(blank=blank, fastemit_lambda=fastemit_lambda,
                         reduction=reduction)


class HSigmoidLoss(nn.Module):
    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.num_classes = num_classes
        std = math.sqrt(2.0 / (num_classes - 1 + feature_size))
        self.weight = Parameter((torch.randn(
            (num_classes - 1, feature_size), generator=generator,
            device=device) * std).to(dtype))
        self.bias = None if bias_attr is False else Parameter(torch.zeros(
            num_classes - 1, device=device, dtype=dtype))

    def forward(self, input, label, path_table=None, path_code=None):
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               bias=self.bias, path_table=path_table,
                               path_code=path_code)
