"""Models of the port."""

from .convert import (ernie_from_jax_state, gpt_from_jax_state,
                      incubate_from_jax_state, llama_from_jax_state,
                      qwen2_moe_from_jax_state)
from .ernie import Ernie, ErnieConfig, ErniePretrainLoss, ernie_tiny
from .generation import GenerationMixin, generate
from .gpt import GPT, GPTConfig, gpt2_small, gpt2_tiny
from .llama import Llama, LlamaConfig, llama3_8b, llama_tiny
from .qwen2_moe import Qwen2Moe, Qwen2MoeConfig, deepseek_moe, qwen2_moe_tiny

__all__ = ["Llama", "LlamaConfig", "llama_tiny", "llama3_8b",
           "llama_from_jax_state", "GPT", "GPTConfig", "gpt2_small",
           "gpt2_tiny", "gpt_from_jax_state", "Qwen2Moe", "Qwen2MoeConfig",
           "qwen2_moe_tiny", "deepseek_moe", "qwen2_moe_from_jax_state",
           "incubate_from_jax_state", "Ernie", "ErnieConfig",
           "ErniePretrainLoss", "ernie_tiny", "ernie_from_jax_state",
           "GenerationMixin", "generate"]
