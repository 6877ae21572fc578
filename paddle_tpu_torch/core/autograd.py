"""``grad``, ``backward`` and ``saved_tensors_hooks`` (counterpart of
paddle_tpu/core/autograd.py) over torch's autograd."""
from __future__ import annotations

import torch

saved_tensors_hooks = torch.autograd.graph.saved_tensors_hooks


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def backward(tensor, grad=None, retain_graph=False):
    """``Tensor.backward``: a non-scalar tensor needs ``grad``."""
    if grad is None:
        if tensor.numel() != 1:
            raise RuntimeError(
                "backward() on a non-scalar Tensor requires an explicit "
                "gradient (shape %s)" % (tuple(tensor.shape),))
        grad = torch.ones_like(tensor)
    torch.autograd.backward([tensor], [grad], retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False):
    """The gradients of ``outputs`` with respect to ``inputs`` (a list),
    without accumulating into ``.grad``. A missing ``grad_outputs`` entry
    is ones; ``retain_graph`` defaults to ``create_graph``; an input the
    outputs do not depend on raises unless ``allow_unused``, and then its
    entry is None. ``create_graph=True`` gives differentiable gradients."""
    outputs = _as_list(outputs)
    inputs = _as_list(inputs)
    if grad_outputs is None:
        grad_outputs = [None] * len(outputs)
    else:
        grad_outputs = _as_list(grad_outputs)
    seeds = [torch.ones_like(o) if g is None else
             (g if isinstance(g, torch.Tensor) else
              torch.as_tensor(g, dtype=o.dtype, device=o.device))
             for o, g in zip(outputs, grad_outputs)]
    if retain_graph is None:
        retain_graph = bool(create_graph)
    results = torch.autograd.grad(outputs, inputs, seeds,
                                  retain_graph=retain_graph,
                                  create_graph=create_graph,
                                  allow_unused=True)
    if not allow_unused and any(r is None for r in results):
        raise RuntimeError(
            "One of the differentiated Tensors appears to not have been "
            "used in the graph (allow_unused=False)")
    return list(results)
