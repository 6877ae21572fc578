"""Adam and AdamW (counterpart of paddle_tpu/optimizer/optimizers.py).

The update rules follow the reference's ``_make_update`` to the letter:
float32 moments, ``pf = p.float()``, bias correction with ``t = step``,
``p <- (pf - lr * m_hat / (sqrt(v_hat) + eps)).to(p.dtype)``. Adam folds
its weight decay into the gradient (L2); AdamW decays the weights
themselves, ``pf *= 1 - lr * wd``, before the update. Plain tensor ops,
as the reference leaves them to XLA.
"""
from __future__ import annotations

import torch

from .optimizer import Optimizer


class _AdamBase(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _slots(self):
        return ("moment1", "moment2")

    def _moments_and_step(self, p, pf, g, slots, lr, step):
        """Updates the moments in place and writes the new parameter."""
        b1, b2 = self._beta1, self._beta2
        m1, m2 = slots
        m1.mul_(b1).add_(g, alpha=1 - b1)
        m2.mul_(b2).add_(g.square(), alpha=1 - b2)
        m1_hat = m1 / (1 - b1 ** step)
        m2_hat = m2 / (1 - b2 ** step)
        p.copy_(pf - lr * m1_hat / (m2_hat.sqrt() + self._epsilon))


class Adam(_AdamBase):
    def _update(self, p, g, slots, lr, step, wd):
        pf = p.float()
        g = g.float()
        if wd:
            g = g + wd * pf   # L2, folded into the gradient
        self._moments_and_step(p, pf, g, slots, lr, step)


class AdamW(_AdamBase):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 grad_clip=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip)

    def _update(self, p, g, slots, lr, step, wd):
        pf = p.float()
        g = g.float()
        if wd:
            pf = pf * (1.0 - lr * wd)   # decoupled decay
        self._moments_and_step(p, pf, g, slots, lr, step)
