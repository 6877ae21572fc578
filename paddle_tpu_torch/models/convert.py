"""Carries weights and optimizer state between the JAX package and the port.

The reference's ``Layer.functional_state()`` gives ``(names, values)``
with names such as ``llama.layers.0.self_attn.q_proj.weight`` and
``lm_head.weight`` (``[hidden, vocab]``: Paddle's ``[in, out]`` layout).
The port keeps the same module names and the same ``Linear`` layout, so
each name maps onto the port parameter of that name unchanged, with no
transpose. The same holds for GPT (``models/gpt.py``): ``wte.weight``,
``blocks.0.qkv.bias``, ``blocks.0.ln1.weight`` ... carry across as they
are, biases and LayerNorm parameters included. So do ERNIE's
(``models/ernie.py``: ``ernie.layers.0.attn.qkv_proj.weight``,
``mlm_head.bias``, ``classifier.weight`` ...) and the ``nn.Transformer``
layers' (``encoder.layers.0.self_attn.q_proj.weight``,
``decoder.layers.5.norm3.bias``; the containers keep the reference's
``layers.<i>`` names, ``nn/layers/container.py``). The arrays arrive as
numpy (or anything ``numpy.asarray`` takes), so this module needs
nothing from JAX.

The reference's ``functional_state()`` gives the parameters and then the
buffers, such as a batch norm's running statistics (``bn1._mean``,
``layer1.0.downsample.1._variance``: ``vision/models/resnet.py``). The
port keeps them as buffers under the same names, so both functions here
cover ``named_parameters()`` and then ``named_buffers()``, with the same
checks.

``export_state`` gives the port's weights back in the same names, and
``load_jax_optimizer_state`` takes a reference train step's optimizer
state (``CompiledTrainStep._opt_state``, ``{name: [moment1, moment2]}``,
and its ``_step_count``), so a port step can resume from a JAX step.
"""
from __future__ import annotations

import numpy as np
import torch


def _state(model):
    """``model``'s parameters and then its buffers, by name."""
    state = dict(model.named_parameters())
    state.update(model.named_buffers())
    return state


def load_jax_state(model, names, arrays):
    """Copy ``arrays`` into ``model``'s parameters and buffers by
    reference name. Every parameter and buffer must be given exactly
    once, with its exact shape; an unknown, missing or repeated name or a
    wrong shape raises ``ValueError`` before anything is copied."""
    params = _state(model)
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


def export_state(model):
    """``(names, arrays)`` of ``model``'s parameters and then its buffers
    in the reference's names, as numpy arrays (bfloat16 tensors widen to
    float32, which holds them exactly; ``load_jax_state`` casts back)."""
    names, arrays = [], []
    for name, p in _state(model).items():
        names.append(name)
        t = p.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        arrays.append(t.numpy())
    return names, arrays


def load_jax_optimizer_state(optimizer, model, names, slots, step):
    """Load a reference optimizer state into ``optimizer`` (built over
    ``model.parameters()``): ``slots[name]`` lists the slot arrays of the
    parameter ``name`` in the optimizer's slot order, for every name in
    ``names``, and ``step`` is the reference's step count, which becomes
    the optimizer's global step. ``names`` must cover ``model``'s
    parameters exactly once; an unknown, missing or repeated name, a
    wrong slot count or a wrong shape raises ``ValueError`` before
    anything is written."""
    params = dict(model.named_parameters())
    names = list(names)
    if len(set(names)) != len(names):
        raise ValueError("load_jax_optimizer_state: repeated names")
    unknown = sorted(set(names) - set(params))
    missing = sorted(set(params) - set(names))
    if unknown or missing:
        raise ValueError("load_jax_optimizer_state: unknown names %s, "
                         "missing names %s" % (unknown, missing))
    slot_names = optimizer._slots()
    values = {}
    for name in names:
        arrs = [np.array(a, dtype=np.float32) for a in slots[name]]
        if len(arrs) != len(slot_names):
            raise ValueError("load_jax_optimizer_state: %s has %d slots, "
                             "the optimizer keeps %d (%s)"
                             % (name, len(arrs), len(slot_names),
                                ", ".join(slot_names)))
        for arr in arrs:
            if tuple(arr.shape) != tuple(params[name].shape):
                raise ValueError("load_jax_optimizer_state: a slot of %s "
                                 "has shape %s, the parameter %s"
                                 % (name, tuple(arr.shape),
                                    tuple(params[name].shape)))
        values[name] = arrs
    for name, arrs in values.items():
        for slot, arr in zip(slot_names, arrs):
            optimizer.set_slot(params[name], slot, torch.from_numpy(arr))
    optimizer._global_step = int(step)
