"""``flops``: count a network's operations (counterpart of
paddle_tpu/hapi/dynamic_flops.py).

Forward hooks on the layers the rules know, one forward on a zeros input
of ``input_size``, the counts summed. The reference's convention: one
multiply-add is ONE flop (a ``Linear`` counts ``in * out`` an output
row, not twice that), a bias adds one an output element, a norm two an
input element, an activation one and a pooling one an output element,
an embedding none. The rules match the layer's exact class, as the
reference's do, mapped onto the port's classes of the same names (its
``SiLU`` rule names no class there or here). ``custom_ops`` maps further
classes to ``fn(layer, inputs, output) -> int``.
"""
from __future__ import annotations

import math

import torch

__all__ = ["flops"]


def _numel(t):
    return math.prod(t.shape)


def _count_conv(layer, inputs, output):
    # kernel_ops from the INPUT channel count (the reference's
    # count_convNd), right for both weight layouts ([out, in/g, *k] and
    # the transposed [in, out/g, *k])
    out_numel = _numel(output)
    in_ch = inputs[0].shape[1]
    k_spatial = _numel(layer.weight) // (
        layer.weight.shape[0] * layer.weight.shape[1])
    kernel_ops = (in_ch // layer.groups) * k_spatial
    total = out_numel * kernel_ops
    if getattr(layer, "bias", None) is not None:
        total += out_numel
    return total


def _count_linear(layer, inputs, output):
    out_numel = _numel(output)
    total = out_numel * layer.weight.shape[0]   # in_features an output
    if getattr(layer, "bias", None) is not None:
        total += out_numel
    return total


def _count_norm(layer, inputs, output):
    return 2 * _numel(inputs[0])   # normalise and scale, an element


def _count_act(layer, inputs, output):
    return _numel(inputs[0])


def _count_pool(layer, inputs, output):
    return _numel(output)


def _count_embedding(layer, inputs, output):
    return 0   # a gather


def _default_rules():
    from ..nn.layers import activation, common, conv, norm, pooling

    groups = [
        (conv, ("Conv1D", "Conv2D", "Conv3D", "Conv2DTranspose",
                "Conv1DTranspose", "Conv3DTranspose"), _count_conv),
        (common, ("Linear",), _count_linear),
        (common, ("Embedding",), _count_embedding),
        (norm, ("BatchNorm1D", "BatchNorm2D", "BatchNorm3D", "BatchNorm",
                "LayerNorm", "GroupNorm", "InstanceNorm1D", "InstanceNorm2D",
                "InstanceNorm3D", "RMSNorm"), _count_norm),
        (pooling, ("MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D",
                   "AvgPool2D", "AvgPool3D", "AdaptiveAvgPool1D",
                   "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
                   "AdaptiveMaxPool2D"), _count_pool),
        (activation, ("ReLU", "ReLU6", "GELU", "Sigmoid", "Tanh", "Softmax",
                      "SiLU", "LeakyReLU", "Hardswish", "Hardsigmoid",
                      "PReLU", "ELU", "Swish", "Mish"), _count_act),
    ]
    rules = {}
    for mod, names, fn in groups:
        for name in names:
            cls = getattr(mod, name, None)
            if cls is not None:
                rules[cls] = fn
    return rules


def flops(net, input_size, custom_ops=None, print_detail=False):
    """Total flops of ``net`` (an ``nn.Module``) on a zeros input of
    ``input_size``, made on the network's device in its dtype."""
    if not isinstance(net, torch.nn.Module):
        raise TypeError("flops counts nn.Module networks (got %r)"
                        % type(net).__name__)
    rules = _default_rules()
    rules.update(custom_ops or {})
    rows = []
    total = [0]
    handles = []

    def make_hook(rule):
        def hook(layer, inputs, output):
            n = int(rule(layer, inputs, output))
            params = sum(p.numel() for p in layer.parameters(recurse=False))
            rows.append((type(layer).__name__, list(inputs[0].shape),
                         list(output.shape)
                         if isinstance(output, torch.Tensor) else None,
                         params, n))
            total[0] += n
        return hook

    for _, sub in net.named_modules():
        rule = rules.get(type(sub))
        if rule is not None:
            handles.append(sub.register_forward_hook(make_hook(rule)))
    first = next(net.parameters(), None)
    device = first.device if first is not None else torch.device("cpu")
    dtype = first.dtype if first is not None else torch.float32
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(torch.zeros(list(input_size), dtype=dtype, device=device))
    finally:
        net.train(was_training)
        for h in handles:
            h.remove()
    if print_detail:
        print("%-20s %-22s %-22s %12s %14s"
              % ("Layer", "Input Shape", "Output Shape", "Params", "FLOPs"))
        for name, ishape, oshape, params, n in rows:
            print("%-20s %-22s %-22s %12d %14d"
                  % (name, ishape, oshape, params, n))
        print("Total FLOPs: %d" % total[0])
    return total[0]
