"""Normalisation layers (counterpart of paddle_tpu/nn/layers/norm.py).

The batch norms keep the reference's running statistics as buffers under
its names, ``_mean`` (zeros) and ``_variance`` (ones), beside ``weight``
(ones) and ``bias`` (zeros), either left out when its attr is False. In
training (and unless ``use_global_stats``) the layer normalises with the
batch's statistics (``batch_norm_pass``, ``F.batch_norm_train``'s one
pass, without its differentiable statistics) and then, under
``torch.no_grad``, sets each buffer to ``old * momentum + batch * (1 -
momentum)`` with the biased batch variance, the reference's rule
(momentum 0.9 weights the old value; torch's own update weights the new
one and stores the unbiased variance, so it is not used). In eval mode,
or with ``use_global_stats``, it normalises with the buffers
(``F.batch_norm_infer``). ``module.to(dtype)`` casts the buffers with the
parameters, as the reference's ``Layer.to`` does, so a bf16 model keeps
bf16 statistics.

``SyncBatchNorm`` is ``BatchNorm`` on one device, as the reference's is
eagerly; ``convert_sync_batchnorm`` swaps every batch norm of a model for
one, parameters and statistics copied. The reference's conversion keeps
only ``num_features``, ``momentum``, ``epsilon`` and ``data_format``: it
drops ``use_global_stats`` and gives a layer built without ``weight`` or
``bias`` a ones weight and a zeros bias, so its result normalises
otherwise than the layer it replaced ("Faults of the reference" 11 in
ROADMAP.md). The port raises ``NotImplementedError`` for such a layer. ``SpectralNorm(weight)`` returns
``weight / sigma`` after ``power_iters`` power iterations from a vector
of ones, as the reference does.

Layers build on ``device`` (the card when None; raises without one) in
``dtype``.
"""
from __future__ import annotations

import torch
from torch import nn

from ...core.tensor import Parameter
from ...device import resolve_device
from .. import functional as F
from ..functional import layer_norm, rms_norm
from ..functional.norm import batch_norm_pass


class RMSNorm(nn.Module):
    def __init__(self, hidden_size, epsilon=1e-6, *, device,
                 dtype=torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.weight = Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype))

    def forward(self, x):
        return rms_norm(x, self.weight, self.epsilon)


class LayerNorm(nn.Module):
    """The reference's LayerNorm: ``weight`` ones and ``bias`` zeros of
    ``normalized_shape``, either left out when its attr is False."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device,
                 dtype=torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight = None if weight_attr is False else Parameter(
            torch.ones(self.normalized_shape, device=device, dtype=dtype))
        self.bias = None if bias_attr is False else Parameter(
            torch.zeros(self.normalized_shape, device=device, dtype=dtype))

    def forward(self, x):
        return layer_norm(x, self.normalized_shape, self.weight, self.bias,
                          epsilon=self.epsilon)


def _affine(num_features, weight_attr, bias_attr, device, dtype):
    """The reference's norm parameters: ``weight`` ones, ``bias`` zeros."""
    weight = None if weight_attr is False else Parameter(
        torch.ones(num_features, device=device, dtype=dtype))
    bias = None if bias_attr is False else Parameter(
        torch.zeros(num_features, device=device, dtype=dtype))
    return weight, bias


class _BatchNormBase(nn.Module):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        self.weight, self.bias = _affine(num_features, weight_attr,
                                         bias_attr, device, dtype)
        self.register_buffer("_mean", torch.zeros(
            num_features, device=device, dtype=dtype))
        self.register_buffer("_variance", torch.ones(
            num_features, device=device, dtype=dtype))

    def forward(self, x):
        if not self.training or self.use_global_stats:
            return F.batch_norm_infer(
                x, self._mean, self._variance, self.weight, self.bias,
                epsilon=self.epsilon, data_format=self.data_format)
        out, mean, var = batch_norm_pass(
            x, self.weight, self.bias, epsilon=self.epsilon,
            data_format=self.data_format)
        m = self.momentum
        with torch.no_grad():
            self._mean.mul_(m).add_(mean, alpha=1.0 - m)
            self._variance.mul_(m).add_(var, alpha=1.0 - m)
        return out


class BatchNorm(_BatchNormBase):
    """The legacy ``paddle.nn.BatchNorm``: ``act`` (a functional's name)
    applied after the norm."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 data_layout="NCHW", *, device=None, dtype=torch.float32,
                 **kwargs):
        super().__init__(num_channels, momentum, epsilon,
                         data_format=data_layout, device=device, dtype=dtype)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        return getattr(F, self._act)(out) if self._act else out


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class SyncBatchNorm(_BatchNormBase):
    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every batch norm (``layer`` itself too) replaced
        by a ``SyncBatchNorm`` holding its parameters and statistics."""
        out = layer
        if isinstance(layer, _BatchNormBase) and not isinstance(
                layer, SyncBatchNorm):
            if (layer.use_global_stats or layer.weight is None
                    or layer.bias is None):
                raise NotImplementedError(
                    "convert_sync_batchnorm: the reference drops "
                    "use_global_stats and weight_attr / bias_attr=False "
                    "(ROADMAP.md, 'Faults of the reference' 11)")
            ref = layer._mean
            out = SyncBatchNorm(layer.num_features, layer.momentum,
                                layer.epsilon,
                                data_format=layer.data_format,
                                device=ref.device, dtype=ref.dtype)
            out.load_state_dict(layer.state_dict())
            out.train(layer.training)
        for name, sub in list(layer.named_children()):
            setattr(out, name, cls.convert_sync_batchnorm(sub))
        return out


class GroupNorm(nn.Module):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__()
        self.num_groups = num_groups
        self.epsilon = epsilon
        self.data_format = data_format
        self.weight, self.bias = _affine(num_channels, weight_attr,
                                         bias_attr, resolve_device(device),
                                         dtype)

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.weight, self.bias,
                            epsilon=self.epsilon,
                            data_format=self.data_format)


class InstanceNorm1D(nn.Module):
    """``momentum`` is the reference's argument and unused, as there."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.data_format = data_format
        self.weight, self.bias = _affine(num_features, weight_attr,
                                         bias_attr, resolve_device(device),
                                         dtype)

    def forward(self, x):
        return F.instance_norm(x, self.weight, self.bias,
                               epsilon=self.epsilon,
                               data_format=self.data_format)


class InstanceNorm2D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format, name, device=device,
                         dtype=dtype)


class InstanceNorm3D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format, name, device=device,
                         dtype=dtype)


class LocalResponseNorm(nn.Module):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self.data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)


class SpectralNorm(nn.Module):
    def __init__(self, weight_shape, axis=0, power_iters=1, epsilon=1e-12,
                 name=None):
        super().__init__()
        self.weight_shape = weight_shape
        self.axis = axis
        self.power_iters = power_iters
        self.epsilon = epsilon

    def forward(self, weight):
        w_mat = weight.movedim(self.axis, 0).reshape(
            weight.shape[self.axis], -1)
        u = torch.ones(w_mat.shape[0], dtype=weight.dtype,
                       device=weight.device)
        for _ in range(self.power_iters):
            v = w_mat.T @ u
            v = v / (torch.linalg.norm(v) + self.epsilon)
            u = w_mat @ v
            u = u / (torch.linalg.norm(u) + self.epsilon)
        return weight / (u @ w_mat @ v)
