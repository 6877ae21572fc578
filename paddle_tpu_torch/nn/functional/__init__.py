from .activation import silu
from .attention import scaled_dot_product_attention
from .loss import cross_entropy
from .norm import rms_norm

__all__ = ["cross_entropy", "rms_norm", "scaled_dot_product_attention",
           "silu"]
