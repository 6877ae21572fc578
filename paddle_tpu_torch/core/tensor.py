"""The port's ``Parameter`` (counterpart of paddle_tpu/core/tensor.py
``Parameter``): an ``nn.Parameter`` with the reference's ``name``.

The reference names every parameter at construction (``param_17``,
``unique_name.generate``), and per-parameter optimizer options key on
that name: AdamW's ``apply_decay_param_fun(param.name)`` and
LarsMomentum's ``exclude_from_weight_decay`` substrings. PaddleNLP's
idiom builds the decay list from the model itself, ``[p.name for n, p in
model.named_parameters() if not any(s in n for s in ("bias", "norm"))]``,
so the name only has to be the same for the model and the optimizer.
Here it is the parameter's path in the model (``ernie.layers.0.ln1.bias``):
every model constructor calls ``name_parameters(self)`` last, so the
outermost model's paths win. A parameter outside any port model has the
name None, as a plain tensor's ``name`` is.

``torch.Tensor.name`` is a read-only slot of the C tensor, so the name
lives in the Python object's ``__dict__`` behind a property of this
subclass; ``copy.deepcopy`` keeps it (``nn.Parameter``'s own deepcopy
does not carry the ``__dict__``).
"""
from __future__ import annotations

from torch import nn


class Parameter(nn.Parameter):
    @property
    def name(self):
        return self.__dict__.get("_name")

    @name.setter
    def name(self, value):
        self.__dict__["_name"] = value

    def __deepcopy__(self, memo):
        out = super().__deepcopy__(memo)
        out.name = self.name
        return out

    def __repr__(self):
        return "Parameter %s containing:\n%r" % (self.name, self.data)


def name_parameters(model):
    """Set each port ``Parameter``'s ``name`` to its path in ``model``
    (``named_parameters()``); returns ``model``."""
    for path, p in model.named_parameters():
        if isinstance(p, Parameter):
            p.name = path
    return model
