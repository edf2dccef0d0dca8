"""Models of the port."""

from .convert import gpt_from_jax_state, llama_from_jax_state
from .gpt import GPT, GPTConfig, gpt2_small, gpt2_tiny
from .llama import Llama, LlamaConfig, llama3_8b, llama_tiny

__all__ = ["Llama", "LlamaConfig", "llama_tiny", "llama3_8b",
           "llama_from_jax_state", "GPT", "GPTConfig", "gpt2_small",
           "gpt2_tiny", "gpt_from_jax_state"]
