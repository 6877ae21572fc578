"""Container layers (counterpart of paddle_tpu/nn/layers/container.py).

``Sequential``, ``LayerList``, ``LayerDict`` and ``ParameterList`` are
PyTorch's ``nn.Sequential``, ``nn.ModuleList``, ``nn.ModuleDict`` and
``nn.ParameterList`` with the reference's constructors. Children keep the
reference's names (``layers.0.``, a ``(name, layer)`` tuple's or an
``OrderedDict``'s key, a ``LayerDict`` key), so
``models.convert.load_jax_state`` carries weights across unchanged; a
slice of a ``Sequential`` or ``LayerList`` is numbered from 0 again, as
the reference rebuilds it.
"""
from __future__ import annotations

import collections

from torch import nn


class Sequential(nn.Sequential):
    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0],
                                           collections.OrderedDict):
            super().__init__(layers[0])
            return
        nn.Module.__init__(self)
        for i, layer in enumerate(layers):
            if isinstance(layer, tuple):
                self.add_module(layer[0], layer[1])
            else:
                self.add_module(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return super().__getitem__(idx)


# the reference's constructors and names are PyTorch's
LayerList = nn.ModuleList
LayerDict = nn.ModuleDict
ParameterList = nn.ParameterList
