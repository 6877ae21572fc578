from .convert import export_state, load_jax_optimizer_state, load_jax_state
from .ernie import (ErnieConfig, ErnieForPretraining,
                    ErnieForSequenceClassification, ErnieModel)
from .generation import DecodeCache, GenerationMixin
from .gpt import GPTModel
from .llama import LlamaConfig, LlamaForCausalLM, rope_apply

__all__ = ["DecodeCache", "ErnieConfig", "ErnieForPretraining",
           "ErnieForSequenceClassification", "ErnieModel", "GPTModel",
           "GenerationMixin", "LlamaConfig", "LlamaForCausalLM",
           "export_state", "load_jax_optimizer_state", "load_jax_state",
           "rope_apply"]
