from .activation import gelu, silu
from .attention import scaled_dot_product_attention, variable_length_attention
from .common import dropout
from .loss import cross_entropy, nll_loss, softmax_with_cross_entropy
from .norm import layer_norm, rms_norm

__all__ = ["cross_entropy", "dropout", "gelu", "layer_norm", "nll_loss",
           "rms_norm", "scaled_dot_product_attention", "silu",
           "softmax_with_cross_entropy", "variable_length_attention"]
