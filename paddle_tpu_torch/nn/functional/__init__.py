from .activation import silu
from .attention import scaled_dot_product_attention
from .norm import rms_norm

__all__ = ["rms_norm", "scaled_dot_product_attention", "silu"]
