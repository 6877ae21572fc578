"""Weight reparameterisations (counterpart of paddle_tpu/nn/utils.py):
``weight_norm`` / ``remove_weight_norm`` and the ``spectral_norm`` hook,
as forward pre-hooks under the reference's parameter names.

``weight_norm(layer, name, dim)`` replaces the parameter ``name`` by
``name_g`` (the norms of its slices along ``dim``) and ``name_v`` (the
parameter itself); before every forward the layer's ``name`` becomes
``g * v / ||v||`` slice by slice. ``spectral_norm(layer, name)`` keeps
the parameter as ``name_orig``; before every forward ``name`` becomes it
divided by its largest singular value, estimated by ``n_power_iterations``
power iterations in float32 whose vectors persist between calls
(``layer._sn_u``, ``layer._sn_v``; plain attributes, not state, as in the
reference). They start from ``numpy.random.RandomState(0)``'s normal
draws, the reference's, so the first iteration matches it exactly.

``remove_weight_norm(layer, name)`` makes the last forward's ``name`` a
plain parameter again and drops ``name_g``, ``name_v`` and ``name_orig``;
like the reference it clears every forward pre-hook of the layer, not
only the one that ``weight_norm`` or ``spectral_norm`` registered.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dispatch import primitive
from ..core.tensor import Parameter


@primitive
def spectral_norm_weight(weight, u, v, dim=0, power_iters=1, eps=1e-12):
    """``(weight / sigma, u, v)`` after ``power_iters`` power iterations
    from ``u`` and ``v``."""
    moved = weight.movedim(dim, 0)
    mat = moved.reshape(moved.shape[0], -1).float()
    uu, vv = u.to(mat), v.to(mat)
    for _ in range(max(power_iters, 0)):
        vv = mat.T @ uu
        vv = vv / torch.linalg.vector_norm(vv).clamp(min=eps)
        uu = mat @ vv
        uu = uu / torch.linalg.vector_norm(uu).clamp(min=eps)
    sigma = uu @ mat @ vv
    out = (mat / sigma.clamp(min=eps)).reshape(moved.shape)
    return (out.movedim(0, dim).to(weight.dtype), uu.to(weight.dtype),
            vv.to(weight.dtype))


@primitive
def weight_norm_apply(v, g, dim=0):
    """``g * v / ||v||`` for each slice of ``v`` along ``dim``."""
    moved = v.movedim(dim, 0)
    flat = moved.reshape(moved.shape[0], -1)
    unit = flat / torch.linalg.vector_norm(flat, dim=1,
                                           keepdim=True).clamp(min=1e-12)
    return (unit * g[:, None]).reshape(moved.shape).movedim(0, dim)


def _move_parameter(layer, name, new_name):
    """Registers ``layer``'s parameter ``name`` as ``new_name`` and
    drops ``name``; returns it."""
    w = layer._parameters.pop(name)
    layer.register_parameter(new_name, w)
    return w


class _SpectralNormHook:
    def __init__(self, layer, name, n_power_iterations, eps, dim):
        self.name = name
        self.n = n_power_iterations
        self.eps = eps
        self.dim = dim
        w = getattr(layer, name)
        rng = np.random.RandomState(0)
        height = w.shape[dim]
        layer._sn_u = torch.from_numpy(
            rng.randn(height).astype(np.float32)).to(w.device)
        layer._sn_v = torch.from_numpy(
            rng.randn(w.numel() // height).astype(np.float32)).to(w.device)
        _move_parameter(layer, name, name + "_orig")

    def __call__(self, layer, inputs):
        w_sn, u, v = spectral_norm_weight(
            getattr(layer, self.name + "_orig"), layer._sn_u, layer._sn_v,
            dim=self.dim, power_iters=self.n, eps=self.eps)
        layer._sn_u, layer._sn_v = u.detach(), v.detach()
        setattr(layer, self.name, w_sn)


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    layer.register_forward_pre_hook(_SpectralNormHook(
        layer, name, n_power_iterations, eps, 0 if dim is None else dim))
    return layer


def weight_norm(layer, name="weight", dim=0):
    w = getattr(layer, name)
    with torch.no_grad():
        moved = w.movedim(dim, 0).reshape(w.shape[dim], -1)
        g = Parameter(torch.linalg.vector_norm(moved, dim=1))
    layer.register_parameter(name + "_g", g)
    _move_parameter(layer, name, name + "_v")

    def hook(mod, inputs):
        setattr(mod, name, weight_norm_apply(
            getattr(mod, name + "_v"), getattr(mod, name + "_g"), dim=dim))

    layer.register_forward_pre_hook(hook)
    return layer


def remove_weight_norm(layer, name="weight"):
    w = getattr(layer, name)
    del layer.__dict__[name]
    for key in (name + "_g", name + "_v", name + "_orig"):
        layer._parameters.pop(key, None)
    layer.register_parameter(name, Parameter(w.detach().clone()))
    layer._forward_pre_hooks.clear()
    layer._forward_pre_hooks_with_kwargs.clear()
    return layer
