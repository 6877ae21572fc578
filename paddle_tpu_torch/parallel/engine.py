"""Single-device train step (counterpart of paddle_tpu/parallel/engine.py
``CompiledTrainStep`` on a one-device mesh: no data, model or ZeRO
parallelism and no quantized gradient sync).

``TrainStep(model, loss_fn, optimizer)(*inputs, labels)`` runs the
forward, the loss, ``backward()`` and the optimizer's update, and
returns the loss as a 0-d tensor without reading it back to the host.
With ``labels_to_model=True`` the model computes the loss itself:
``model(*inputs, labels)`` (``loss_fn`` then applies to its output, or
is None). The gradients of the last step stay on the parameters until
the next step clears them, so a caller can read them.

Each phase runs under a ``torch.profiler.record_function`` range
(``train_step.forward`` / ``.loss`` / ``.backward`` / ``.optimizer``),
which ``tools/train_profile.py`` uses to attribute device time.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from ..device import resolve_device


class TrainStep:
    def __init__(self, model, loss_fn, optimizer, labels_to_model=False,
                 device=None):
        """``device`` defaults to the card and raises without one; the
        model's parameters must already live on it."""
        self.device = resolve_device(device)
        model_device = next(model.parameters()).device
        if model_device != self.device:
            raise ValueError("TrainStep on %s got a model on %s"
                             % (self.device, model_device))
        if loss_fn is None and not labels_to_model:
            raise ValueError("loss_fn is required unless labels_to_model")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.labels_to_model = labels_to_model

    def __call__(self, *batch):
        """``batch = (*inputs, labels)`` as tensors or arrays; returns the
        loss (0-d tensor on the step's device)."""
        inputs = [torch.as_tensor(b, device=self.device) for b in batch]
        self.optimizer.clear_grad()
        with record_function("train_step.forward"):
            if self.labels_to_model:
                out = self.model(*inputs)
            else:
                out = self.model(*inputs[:-1])
        with record_function("train_step.loss"):
            if self.loss_fn is not None:
                out = self.loss_fn(out, inputs[-1])
        with record_function("train_step.backward"):
            out.backward()
        with record_function("train_step.optimizer"):
            self.optimizer.step()
        return out.detach()

    step = __call__
