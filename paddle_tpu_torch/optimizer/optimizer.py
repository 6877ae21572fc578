"""Optimizer base (counterpart of paddle_tpu/optimizer/optimizer.py).

Each optimizer keeps one list of slots (its accumulators) per parameter,
created by ``_init_slot``: zeros in float32 whatever the parameter's
dtype by default (the reference's master-moment practice for bf16
training), zeros of the parameter's dtype where the reference keeps them
so (its base ``_init_slot``, ``zeros_like(param)``: Momentum, RMSProp),
and one global step. ``step()`` increments the global step before it
updates, so the first update uses t = 1, as the reference's compiled step
does. The update rule of each subclass is ``_update(p, g, slots, lr, step,
wd)``: it writes the new parameter and slots in place, under
``torch.no_grad()``. ``wd`` is ``_decay_for(p)``, the parameter's own
decay: the optimizer's by default, 0 where a subclass's option excludes
the parameter (AdamW's ``apply_decay_param_fun``, Lamb's
``exclude_from_weight_decay_fn``, LarsMomentum's name substrings).

``learning_rate`` is a float or an ``LRScheduler`` (``optimizer/lr.py``):
``get_lr()`` then reads the scheduler, ``set_lr`` raises, and the caller
steps the scheduler, as in the reference. ``grad_clip`` (a
``ClipGradBy*`` of ``optimizer/clip.py``) clips the gradients in
``step()`` before the update.

``weight_decay`` is a float or an ``L2Decay``. An ``L1Decay`` can be
built, but an optimizer given one raises ``NotImplementedError``: the
reference reads any regularizer's ``_coeff`` and folds it in as L2
(``_weight_decay_value``, "Faults of the reference" 6 in ROADMAP.md), so
its ``L1Decay`` decays like an ``L2Decay``, and the port refuses that
rather than copy it.

``state_dict()`` keeps the reference's keys: ``"<slot>/<index>"`` (the
parameter's index in the list given at construction), ``"global_step"``
and, under a scheduler, ``"LR_Scheduler"``.
"""
from __future__ import annotations

import torch

from ..core.dispatch import primitive_scope
from .lr import LRScheduler


class L2Decay:
    """paddle.regularizer.L2Decay analog: a weight-decay coefficient."""

    def __init__(self, coeff=0.0):
        self._coeff = coeff


class L1Decay:
    """paddle.regularizer.L1Decay analog: an L1 coefficient, which no
    optimizer takes yet (see the module's docstring)."""

    def __init__(self, coeff=0.0):
        self._coeff = coeff


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if isinstance(weight_decay, L1Decay):
            raise NotImplementedError(
                "L1Decay: the reference folds every regularizer's _coeff "
                "in as L2 decay (optimizer.py _weight_decay_value; "
                "\"Faults of the reference\" 6 in ROADMAP.md), so an "
                "L1Decay would decay like an L2Decay; use L2Decay or a "
                "float")
        self._lr_scheduler = None
        if isinstance(learning_rate, LRScheduler):
            self._lr_scheduler = learning_rate
            self._lr = learning_rate()
        else:
            self._lr = float(learning_rate)
        self._grad_clip = grad_clip
        self._params = None if parameters is None else list(parameters)
        self._weight_decay = weight_decay
        self._slots_of = {}   # id(param) -> [float32 slot tensors]
        self._global_step = 0

    # -- public API --------------------------------------------------------
    def get_lr(self):
        if self._lr_scheduler is not None:
            return float(self._lr_scheduler())
        return self._lr

    def set_lr(self, value):
        if self._lr_scheduler is not None:
            raise RuntimeError("set_lr is not allowed when learning rate is "
                               "an LRScheduler")
        self._lr = float(value)

    @torch.no_grad()
    def step(self):
        """One update of every parameter with a gradient. Its arithmetic is
        no op of the model: ``amp.auto_cast`` casts none of it (as the
        reference's update, pure array math, is never cast)."""
        with primitive_scope():
            pg = [(p, p.grad) for p in self._get_params()
                  if p.grad is not None]
            if self._grad_clip is not None:
                pg = self._grad_clip(pg)
            lr = self.get_lr()
            self._global_step += 1
            for p, g in pg:
                self._update(p, g, self._get_slots(p), lr, self._global_step,
                             self._decay_for(p))

    @torch.no_grad()
    def clear_grad(self):
        for p in self._get_params():
            p.grad = None

    def state_dict(self):
        sd = {}
        for i, p in enumerate(self._get_params()):
            slots = self._slots_of.get(id(p))
            if slots is not None:
                for name, value in zip(self._slots(), slots):
                    sd["%s/%d" % (name, i)] = value
        sd["global_step"] = self._global_step
        if self._lr_scheduler is not None:
            sd["LR_Scheduler"] = self._lr_scheduler.state_dict()
        return sd

    def set_state_dict(self, sd):
        params = self._get_params()
        for key, value in sd.items():
            if key == "global_step":
                self._global_step = int(value)
                continue
            if key == "LR_Scheduler":
                self._lr_scheduler.set_state_dict(value)
                continue
            name, index = key.rsplit("/", 1)
            p = params[int(index)]
            self.set_slot(p, name, value)

    def set_slot(self, param, name, value):
        """Overwrite one slot of ``param`` (in the slot's dtype, on the
        parameter's device) with ``value`` (a tensor or anything
        ``torch.as_tensor`` takes, of the parameter's shape)."""
        slots = self._get_slots(param)
        value = torch.as_tensor(value)
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError("slot %s has shape %s, the parameter %s"
                             % (name, tuple(value.shape), tuple(param.shape)))
        slots[self._slots().index(name)].copy_(value)

    # -- machinery ---------------------------------------------------------
    def _get_params(self):
        if self._params is None:
            raise ValueError("Optimizer created without a parameters list; "
                             "pass parameters=model.parameters()")
        return self._params

    def _slots(self):
        """Accumulator slot names, e.g. ('moment1', 'moment2')."""
        return ()

    def _init_slot(self, slot, param):
        return torch.zeros(param.shape, dtype=torch.float32,
                           device=param.device)

    def _get_slots(self, param):
        slots = self._slots_of.get(id(param))
        if slots is None:
            slots = [self._init_slot(slot, param) for slot in self._slots()]
            self._slots_of[id(param)] = slots
        return slots

    def _decay_for(self, param):
        return self._weight_decay_value()

    def _weight_decay_value(self):
        wd = self._weight_decay
        if wd is None:
            return 0.0
        if isinstance(wd, (int, float)):
            return float(wd)
        return float(wd._coeff)

    def _update(self, p, g, slots, lr, step, wd):
        raise NotImplementedError
