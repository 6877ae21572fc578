"""The concrete optimizers (counterpart of paddle_tpu/optimizer/optimizers.py).

Each ``_update`` follows the reference's ``_make_update`` to the letter,
in the dtype the reference computes in:

* ``SGD``, ``Momentum`` and ``RMSProp`` compute in the parameter's dtype
  with their slots in it (the reference's ``zeros_like(param)``): each op
  rounds its result to that dtype, as the reference's compiled update
  does, and the Python scalars (learning rate, decay, momentum, ``rho``,
  ``epsilon``) are rounded to it first, as JAX rounds a weak-typed scalar
  (and ``lr.astype(p.dtype)``);
* the Adam family (``Adam``, ``AdamW``, ``Adamax``, ``Lamb``),
  ``LarsMomentum``, ``Adagrad`` and ``Adadelta`` compute in float32 on
  float32 slots (``pf = p.float()``) and cast the new parameter back.

L2 weight decay is folded into the gradient (``g + wd * p``) except in
AdamW (``pf *= 1 - lr * wd``, decoupled), Lamb (``wd * pf`` in the trust
ratio's update) and LarsMomentum (``lars_weight_decay``). Slot names and
orders are the reference's ``_slots()``, so ``state_dict()`` keys and
``models.convert.load_jax_optimizer_state`` match its state.

The parameters the reference accepts and never reads are accepted here
too and do nothing: ``lazy_mode`` (sparse updates; every gradient here is
dense), ``multi_precision`` (the moments are float32 anyway) and
``name``. AdamW's ``lr_ratio`` is the exception: the reference accepts
it and never applies it ("Faults of the reference" 7 in ROADMAP.md), so
the port raises ``NotImplementedError`` for any value but None instead of
dropping it.

Plain tensor ops, as the reference leaves them to XLA.
"""
from __future__ import annotations

import torch

from .optimizer import Optimizer


def _wd(p, g, wd):
    """L2 decay folded into the gradient (the reference's ``_wd``)."""
    return g + wd * p if wd else g


def _as(x, p):
    """The scalar ``x`` rounded to ``p``'s dtype, as a Python float."""
    return float(torch.tensor(x, dtype=torch.float64).to(p.dtype))


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _update(self, p, g, slots, lr, step, wd):
        p.copy_(p - _as(lr, p) * _wd(p, g, _as(wd, p)))


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _slots(self):
        return ("velocity",)

    def _init_slot(self, slot, param):
        return torch.zeros_like(param, memory_format=torch.contiguous_format)

    def _update(self, p, g, slots, lr, step, wd):
        (v,) = slots
        mu = _as(self._momentum, p)
        g = _wd(p, g, _as(wd, p))
        v2 = mu * v + g
        upd = g + mu * v2 if self._nesterov else v2
        v.copy_(v2)
        p.copy_(p - _as(lr, p) * upd)


class LarsMomentum(Optimizer):
    """LARS: momentum with a layer-adaptive local learning rate,
    ``local_lr = lr * lars_coeff * |p| / (|g| + wd * |p| + eps)`` (``lr``
    where either norm is 0), ``v' = mu * v + local_lr * (g + wd * p)``,
    ``p' = p - v'``. ``exclude_from_weight_decay`` lists substrings of
    ``param.name`` whose parameters take no decay."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 epsilon=1e-9, exclude_from_weight_decay=None, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay
        self._epsilon = epsilon
        self._exclude = list(exclude_from_weight_decay or [])

    def _slots(self):
        return ("velocity",)

    def _decay_for(self, param):
        name = param.name or ""
        if any(s in name for s in self._exclude):
            return 0.0
        return self._lars_weight_decay

    def _update(self, p, g, slots, lr, step, wd):
        (v,) = slots
        pf, gf = p.float(), g.float()
        pn = pf.square().sum().sqrt()
        gn = gf.square().sum().sqrt()
        local = lr * self._lars_coeff * pn / (gn + wd * pn + self._epsilon)
        local = torch.where((pn > 0) & (gn > 0), local,
                            torch.tensor(lr, dtype=torch.float32,
                                         device=p.device))
        v2 = self._momentum * v + local * (gf + wd * pf)
        v.copy_(v2)
        p.copy_(pf - v2)


class _AdamBase(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=True,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _slots(self):
        return ("moment1", "moment2")

    def _moments(self, g, slots, step):
        """Updates the moments in place; returns their bias-corrected
        values."""
        b1, b2 = self._beta1, self._beta2
        m1, m2 = slots
        m1.mul_(b1).add_(g, alpha=1 - b1)
        m2.mul_(b2).add_(g.square(), alpha=1 - b2)
        return m1 / (1 - b1 ** step), m2 / (1 - b2 ** step)

    def _adam_step(self, p, pf, g, slots, lr, step):
        m1_hat, m2_hat = self._moments(g, slots, step)
        p.copy_(pf - lr * m1_hat / (m2_hat.sqrt() + self._epsilon))


class Adam(_AdamBase):
    def _update(self, p, g, slots, lr, step, wd):
        pf = p.float()
        self._adam_step(p, pf, _wd(pf, g.float(), wd), slots, lr, step)


class AdamW(_AdamBase):
    """Adam with decoupled weight decay. ``apply_decay_param_fun(name)``,
    when given, is called with each parameter's ``name``
    (``core.tensor.Parameter``: its path in the model) and the parameter
    is decayed only where it returns True, as the reference's
    ``_decay_for`` does."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=True, name=None):
        if lr_ratio is not None:
            raise NotImplementedError(
                "AdamW: lr_ratio is not applied by the reference either "
                "(ROADMAP.md, 'Faults of the reference' 7)")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decay_for(self, param):
        if (self._apply_decay_param_fun is not None
                and not self._apply_decay_param_fun(param.name)):
            return 0.0
        return self._weight_decay_value()

    def _update(self, p, g, slots, lr, step, wd):
        pf = p.float()
        if wd:
            pf = pf * (1.0 - lr * wd)   # decoupled decay
        self._adam_step(p, pf, g.float(), slots, lr, step)


class Adamax(_AdamBase):
    def _update(self, p, g, slots, lr, step, wd):
        b1, b2 = self._beta1, self._beta2
        m, u = slots
        pf = p.float()
        g = _wd(pf, g.float(), wd)
        m.copy_(b1 * m + (1 - b1) * g)
        u.copy_(torch.maximum(b2 * u, g.abs()))
        p.copy_(pf - lr / (1 - b1 ** step) * m / (u + self._epsilon))


class Lamb(_AdamBase):
    """LAMB: the Adam direction plus ``wd * p``, scaled by the trust ratio
    ``|p| / |r|`` (1 where either norm is 0).
    ``exclude_from_weight_decay_fn(param)`` True takes the parameter's
    decay to 0."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         lamb_weight_decay, grad_clip)
        self._exclude_fn = exclude_from_weight_decay_fn

    def _decay_for(self, param):
        if self._exclude_fn is not None and self._exclude_fn(param):
            return 0.0
        return self._weight_decay_value()

    def _update(self, p, g, slots, lr, step, wd):
        pf = p.float()
        m1_hat, m2_hat = self._moments(g.float(), slots, step)
        r = m1_hat / (m2_hat.sqrt() + self._epsilon) + wd * pf
        w_norm = torch.linalg.vector_norm(pf)
        r_norm = torch.linalg.vector_norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0),
                            w_norm / torch.clamp(r_norm, min=1e-12),
                            torch.ones_like(w_norm))
        p.copy_(pf - lr * trust * r)


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _slots(self):
        return ("mean_square", "mean_grad", "momentum")

    def _init_slot(self, slot, param):
        return torch.zeros_like(param, memory_format=torch.contiguous_format)

    def _update(self, p, g, slots, lr, step, wd):
        ms, mg, mom = slots
        rho, rest, eps = (_as(x, p) for x in (self._rho, 1 - self._rho,
                                              self._epsilon))
        g = _wd(p, g, _as(wd, p))
        ms.copy_(rho * ms + rest * g.square())
        if self._centered:
            mg.copy_(rho * mg + rest * g)
            denom = (ms - mg.square() + eps).sqrt()
        else:
            denom = (ms + eps).sqrt()
        mom.copy_(_as(self._momentum, p) * mom + _as(lr, p) * g / denom)
        p.copy_(p - mom)


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._init_value = initial_accumulator_value

    def _slots(self):
        return ("moment",)

    def _init_slot(self, slot, param):
        return torch.full(param.shape, self._init_value, dtype=torch.float32,
                          device=param.device)

    def _update(self, p, g, slots, lr, step, wd):
        (mom,) = slots
        pf = p.float()
        g = _wd(pf, g.float(), wd)
        mom.add_(g.square())
        p.copy_(pf - lr * g / (mom.sqrt() + self._epsilon))


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._rho = rho

    def _slots(self):
        return ("avg_squared_grad", "avg_squared_update")

    def _update(self, p, g, slots, lr, step, wd):
        eg, ex = slots
        rho, eps = self._rho, self._epsilon
        pf = p.float()
        g = _wd(pf, g.float(), wd)
        eg.copy_(rho * eg + (1 - rho) * g.square())
        upd = (ex + eps).sqrt() / (eg + eps).sqrt() * g
        ex.copy_(rho * ex + (1 - rho) * upd.square())
        p.copy_(pf - lr * upd)
