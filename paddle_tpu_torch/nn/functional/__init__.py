from .activation import (
    celu, elu, elu_, gelu, glu, gumbel_softmax, hardshrink, hardsigmoid,
    hardswish, hardtanh, leaky_relu, log_sigmoid, log_softmax, maxout, mish,
    prelu, relu, relu6, relu_, rrelu, selu, sigmoid, silu, softmax, softmax_,
    softplus, softshrink, softsign, swish, tanh, tanh_, tanhshrink,
    thresholded_relu)
from .attention import scaled_dot_product_attention, variable_length_attention
from .common import dropout
from .loss import cross_entropy, nll_loss, softmax_with_cross_entropy
from .norm import layer_norm, rms_norm

__all__ = ["celu", "cross_entropy", "dropout", "elu", "elu_", "gelu", "glu",
           "gumbel_softmax", "hardshrink", "hardsigmoid", "hardswish",
           "hardtanh", "layer_norm", "leaky_relu", "log_sigmoid",
           "log_softmax", "maxout", "mish", "nll_loss", "prelu", "relu",
           "relu6", "relu_", "rms_norm", "rrelu",
           "scaled_dot_product_attention", "selu", "sigmoid", "silu",
           "softmax", "softmax_", "softmax_with_cross_entropy", "softplus",
           "softshrink", "softsign", "swish", "tanh", "tanh_", "tanhshrink",
           "thresholded_relu", "variable_length_attention"]
