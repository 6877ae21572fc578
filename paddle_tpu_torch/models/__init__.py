from .convert import export_state, load_jax_optimizer_state, load_jax_state
from .generation import DecodeCache, GenerationMixin
from .gpt import GPTModel
from .llama import LlamaConfig, LlamaForCausalLM, rope_apply

__all__ = ["DecodeCache", "GPTModel", "GenerationMixin", "LlamaConfig",
           "LlamaForCausalLM", "export_state", "load_jax_optimizer_state",
           "load_jax_state", "rope_apply"]
