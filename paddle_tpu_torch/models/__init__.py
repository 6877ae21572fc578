from .convert import export_state, load_jax_optimizer_state, load_jax_state
from .llama import LlamaConfig, LlamaForCausalLM, rope_apply

__all__ = ["LlamaConfig", "LlamaForCausalLM", "export_state",
           "load_jax_optimizer_state", "load_jax_state", "rope_apply"]
