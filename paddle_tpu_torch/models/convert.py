"""Loads the JAX package's weights into the port's modules.

The reference's ``Layer.functional_state()`` gives ``(names, values)``
with names such as ``llama.layers.0.self_attn.q_proj.weight`` and
``lm_head.weight`` (``[hidden, vocab]``: Paddle's ``[in, out]`` layout).
The port keeps the same module names and the same ``Linear`` layout, so
each name maps onto the port parameter of that name unchanged, with no
transpose. The arrays arrive as numpy (or anything ``numpy.asarray``
takes), so this module needs nothing from JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def load_jax_state(model, names, arrays):
    """Copy ``arrays`` into ``model``'s parameters by reference name.
    Every parameter must be given exactly once, with its exact shape;
    an unknown, missing or repeated name or a wrong shape raises
    ``ValueError`` before anything is copied."""
    params = dict(model.named_parameters())
    names = list(names)
    arrays = [np.asarray(a) for a in arrays]
    if len(names) != len(arrays):
        raise ValueError("load_jax_state: %d names for %d arrays"
                         % (len(names), len(arrays)))
    if len(set(names)) != len(names):
        raise ValueError("load_jax_state: repeated names")
    unknown = sorted(set(names) - set(params))
    missing = sorted(set(params) - set(names))
    if unknown or missing:
        raise ValueError("load_jax_state: unknown names %s, missing names %s"
                         % (unknown, missing))
    for name, arr in zip(names, arrays):
        if tuple(arr.shape) != tuple(params[name].shape):
            raise ValueError("load_jax_state: %s has shape %s, the port "
                             "expects %s" % (name, tuple(arr.shape),
                                             tuple(params[name].shape)))
    with torch.no_grad():
        for name, arr in zip(names, arrays):
            p = params[name]
            p.copy_(torch.tensor(arr, dtype=p.dtype))
