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

The step runs the model in the mode its caller left it in (a new model
is in training mode), as the reference's does. A model's buffers, such as
a batch norm's running statistics (``nn/layers/norm.py``), move in place
in its forward, so they move once a step, outside autograd.

``run_steps(*stacked_batch)`` runs K steps, one per slice of a leading K
axis, and returns the last step's loss (float32, not read back). As in
the reference, all K steps of a window take the learning rate current
when the window starts (the caller steps an ``LRScheduler`` between
calls, so one that it steps per call advances per window), and the
optimizer's step counter advances per step (Adam's bias correction
stays exact). Here the window is a host loop of K steps; the reference's
one device call is a later speed-up (CUDA graphs).

``loss_reduction`` ("mean" or "sum") declares how ``loss_fn`` reduces over
the batch. The reference needs it only to combine per-rank losses of its
quantized gradient sync; on one device it changes nothing else.

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
                 device=None, loss_reduction="mean"):
        """``device`` defaults to the card and raises without one; the
        model's parameters must already live on it."""
        self.device = resolve_device(device)
        model_device = next(model.parameters()).device
        if model_device != self.device:
            raise ValueError("TrainStep on %s got a model on %s"
                             % (self.device, model_device))
        if loss_fn is None and not labels_to_model:
            raise ValueError("loss_fn is required unless labels_to_model")
        if loss_reduction not in ("mean", "sum"):
            raise ValueError(
                "loss_reduction must be 'mean' or 'sum', got %r"
                % (loss_reduction,))
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.labels_to_model = labels_to_model
        self.loss_reduction = loss_reduction

    def _step(self, inputs):
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

    def __call__(self, *batch):
        """``batch = (*inputs, labels)`` as tensors or arrays; returns the
        loss (0-d tensor on the step's device)."""
        return self._step([torch.as_tensor(b, device=self.device)
                           for b in batch])

    step = __call__

    def run_steps(self, *stacked_batch):
        """``stacked_batch = (*inputs, labels)``, each ``[K, ...]``: step i
        takes slice i. Returns the last step's loss as a float32 0-d
        tensor."""
        stacked = [torch.as_tensor(b, device=self.device)
                   for b in stacked_batch]
        ks = {int(b.shape[0]) if b.dim() else None for b in stacked}
        if len(ks) != 1 or None in ks or 0 in ks:
            raise ValueError("run_steps: every input needs the same "
                             "leading K >= 1 axis, got shapes %s"
                             % [tuple(b.shape) for b in stacked])
        for i in range(ks.pop()):
            loss = self._step([b[i] for b in stacked])
        return loss.float()
