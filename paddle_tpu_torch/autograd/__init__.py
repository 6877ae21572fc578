"""``paddle.autograd`` (counterpart of paddle_tpu/autograd/__init__.py):
``grad``, ``backward``, ``no_grad`` / ``enable_grad``,
``saved_tensors_hooks``, and ``PyLayer`` over ``torch.autograd.Function``.

A ``PyLayer`` subclass writes static ``forward(ctx, *args)`` and
``backward(ctx, *grads)``; ``apply`` runs the forward without recording
it and, where a tensor argument needs a gradient, records one node whose
backward is the subclass's. ``backward`` returns one gradient a tensor
argument, in order (None for none). ``ctx.save_for_backward`` keeps
tensors through the ``saved_tensors_hooks`` active when it is called, and
``ctx.saved_tensor()`` gives them back as a list. Several outputs come
back as a list, as the reference returns them.
"""
from __future__ import annotations

import torch

from ..core.autograd import grad, saved_tensors_hooks
from ..core.dispatch import enable_grad, no_grad


def backward(tensors, grad_tensors=None, retain_graph=False):
    tensors = tensors if isinstance(tensors, (list, tuple)) else [tensors]
    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    seeds = [torch.ones_like(t) if g is None else g
             for t, g in zip(tensors, grad_tensors)]
    torch.autograd.backward(list(tensors), seeds, retain_graph=retain_graph)


class PyLayerContext:
    """What ``forward`` and ``backward`` share: saved tensors and
    ``attrs``, plus any attribute set on it."""

    def __init__(self, fctx=None):
        self._fctx = fctx
        self.attrs = {}

    def save_for_backward(self, *tensors):
        self._fctx.save_for_backward(*tensors)

    def saved_tensor(self):
        return list(self._fctx.saved_tensors)


class _PyLayerFunction(torch.autograd.Function):
    @staticmethod
    def forward(fctx, layer, kwargs, *args):
        ctx = PyLayerContext(fctx)
        fctx.pylayer = (layer, ctx,
                        [isinstance(a, torch.Tensor) for a in args])
        outs = layer.forward(ctx, *args, **kwargs)
        fctx.single = not isinstance(outs, (tuple, list))
        return outs if fctx.single else tuple(outs)

    @staticmethod
    def backward(fctx, *grads):
        layer, ctx, is_tensor = fctx.pylayer
        gs = layer.backward(ctx, *grads)
        gs = [gs] if gs is None or isinstance(gs, torch.Tensor) else list(gs)
        it = iter(gs)
        return (None, None) + tuple(next(it, None) if t else None
                                    for t in is_tensor)


class PyLayer:
    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        outs = _PyLayerFunction.apply(cls, kwargs, *args)
        return outs if isinstance(outs, torch.Tensor) else list(outs)


__all__ = ["PyLayer", "PyLayerContext", "backward", "enable_grad", "grad",
           "no_grad", "saved_tensors_hooks"]
