from .convert import load_jax_state
from .llama import LlamaConfig, LlamaForCausalLM, rope_apply

__all__ = ["LlamaConfig", "LlamaForCausalLM", "load_jax_state", "rope_apply"]
