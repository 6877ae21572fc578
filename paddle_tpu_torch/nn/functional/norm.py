"""Normalisation functionals
(counterpart of paddle_tpu/nn/functional/norm.py).

Every variance is the biased one (``jnp.var``), as in the reference.
``batch_norm_train`` returns ``(out, batch_mean, batch_var)`` and leaves
the running statistics to its caller (``nn.layers.norm``): the output is
torch's ``batch_norm`` in training mode (one fused normalisation and its
backward), and the batch statistics come out of that same pass, through
scratch running statistics at momentum 1 (``batch_norm_pass``).
``batch_norm_infer`` normalises with the given statistics in
plain tensor ops, so that, as in the reference, it is differentiable in
all of them. ``group_norm`` and ``instance_norm`` are torch's, which
normalise with the same biased variance; ``local_response_norm`` divides
by ``(k + alpha * s) ** beta`` with ``s`` the *sum* of squares over the
window of channels, the reference's rule (torch's own divides ``alpha``
by the window size). All plain PyTorch: the reference has no Pallas
kernel here.

Where each channel (batch norm) or each instance's channel (instance
norm) holds one value, torch's fused passes raise; the reference's
``jnp.var`` gives 0 there, so the output is ``bias`` (or 0) and the
running variance decays by ``momentum``. That count is a shape, known on
the host, so those calls take the plain formula (``_plain_norm``) and
every other shape keeps the fused pass.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...core.dispatch import primitive


@primitive
def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm over the trailing ``normalized_shape`` axes with the
    biased variance, in ``x``'s dtype, as the reference computes it."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    axes = tuple(range(x.dim() - len(tuple(normalized_shape)), x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, keepdim=True, unbiased=False)
    out = (x - mean) / torch.sqrt(var + epsilon)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


@primitive
def rms_norm(x, weight=None, epsilon=1e-6):
    """RMSNorm with float32 statistics for any input dtype; the result is
    cast back to ``x``'s dtype before the weight multiplies it, as in the
    reference."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    out = (xf * torch.reciprocal(torch.sqrt(ms + epsilon))).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out


def _channel_axis(x, data_format):
    return 1 if data_format.startswith("NC") else x.dim() - 1


@primitive
def batch_norm_infer(x, running_mean, running_var, weight=None, bias=None,
                     epsilon=1e-5, data_format="NCHW"):
    """``(x - mean) / sqrt(var + epsilon) * weight + bias`` on the given
    statistics, per channel."""
    ch = _channel_axis(x, data_format)
    shape = [-1 if d == ch else 1 for d in range(x.dim())]
    out = (x - running_mean.reshape(shape)) / torch.sqrt(
        running_var.reshape(shape) + epsilon)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def _plain_norm(xc, axes, weight, bias, epsilon):
    """``(xc - mean) / sqrt(var + epsilon) * weight + bias`` with the
    biased statistics over ``axes`` of ``xc`` (channels on axis 1), in
    plain tensor ops; returns ``(out, mean, var)``, the statistics with
    the kept axes only."""
    mean = xc.mean(dim=axes, keepdim=True)
    var = xc.var(dim=axes, keepdim=True, unbiased=False)
    out = (xc - mean) / torch.sqrt(var + epsilon)
    shape = [1, -1] + [1] * (xc.dim() - 2)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out, mean, var


class _BatchStats(torch.autograd.Function):
    """The batch's mean and biased variance of ``xc`` (channels on axis
    1), computed by the caller, made differentiable in ``xc``:
    ``d mean = 1 / n`` and ``d var = 2 (x - mean) / n``. Nothing runs
    backward unless a gradient reaches the statistics."""

    @staticmethod
    def forward(ctx, xc, mean, var):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(xc, mean)
        return mean.clone(), var.clone()

    @staticmethod
    def backward(ctx, g_mean, g_var):
        xc, mean = ctx.saved_tensors
        shape = [1, -1] + [1] * (xc.dim() - 2)
        n = xc.numel() // xc.shape[1]
        gx = None
        if g_mean is not None:
            gx = (g_mean / n).reshape(shape).expand_as(xc)
        if g_var is not None:
            gv = (xc - mean.reshape(shape)) * (2.0 * g_var / n).reshape(shape)
            gx = gv if gx is None else gx + gv
        return gx, None, None


@primitive(name="batch_norm_train")
def batch_norm_pass(x, weight=None, bias=None, epsilon=1e-5,
                    data_format="NCHW"):
    """torch's fused training batch norm, once: ``(out, batch_mean,
    batch_var)``, the statistics out of the same pass through scratch
    running statistics at momentum 1, carrying no gradient (torch's
    running variance is the unbiased one: it is scaled by ``(n - 1) /
    n``). The reference's ``batch_norm_train`` primitive: its AMP cast
    point."""
    ch = _channel_axis(x, data_format)
    xc = x.movedim(ch, 1)
    n = xc.numel() // xc.shape[1]
    if n == 1:                          # torch's fused pass raises here
        axes = [d for d in range(xc.dim()) if d != 1]
        out, mean, var = _plain_norm(xc, axes, weight, bias, epsilon)
        return (out.movedim(1, ch), mean.detach().flatten(),
                var.detach().flatten())
    like = weight if weight is not None else xc
    mean, var = torch.zeros(2, xc.shape[1], device=xc.device,
                            dtype=like.dtype).unbind()
    out = TF.batch_norm(xc, mean, var, weight, bias, training=True,
                        momentum=1.0, eps=epsilon)
    return out.movedim(1, ch), mean, var * ((n - 1) / n)


@primitive
def batch_norm_train(x, weight=None, bias=None, epsilon=1e-5,
                     data_format="NCHW"):
    """Returns ``(out, batch_mean, batch_var)``, the statistics
    differentiable in ``x``; the caller updates the running
    statistics."""
    out, mean, var = batch_norm_pass(x, weight, bias, epsilon, data_format)
    xc = x.movedim(_channel_axis(x, data_format), 1)
    mean, var = _BatchStats.apply(xc, mean, var)
    return out, mean, var


@primitive
def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-5,
               data_format="NCHW"):
    ch = _channel_axis(x, data_format)
    out = TF.group_norm(x.movedim(ch, 1), int(num_groups), weight, bias,
                        epsilon)
    return out.movedim(1, ch)


@primitive
def instance_norm(x, weight=None, bias=None, epsilon=1e-5,
                  data_format="NCHW"):
    ch = _channel_axis(x, data_format)
    xc = x.movedim(ch, 1)
    if xc[0, 0].numel() == 1:           # torch's fused pass raises here
        out = _plain_norm(xc, list(range(2, xc.dim())), weight, bias,
                          epsilon)[0]
    else:
        out = TF.instance_norm(xc, weight=weight, bias=bias, eps=epsilon)
    return out.movedim(1, ch)


@primitive
def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW"):
    ch = _channel_axis(x, data_format)
    sq = x.square().movedim(ch, -1)
    half = size // 2
    sums = TF.pad(sq, [half, size - half - 1]).unfold(-1, size, 1).sum(-1)
    return x / (k + alpha * sums.movedim(-1, ch)).pow(beta)
