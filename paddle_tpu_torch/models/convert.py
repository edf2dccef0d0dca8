"""Carry a JAX ``paddle_tpu`` Llama's, GPT's, Qwen2-MoE's or ERNIE's weights
into the port's :class:`Llama`, :class:`GPT`, :class:`Qwen2Moe` or
:class:`Ernie`.

The JAX model's ``state_dict()`` arrives as numpy arrays under the same
keys. ``paddle_tpu``'s ``Linear`` stores its weight ``[in, out]``
(``paddle_tpu/nn/layers/common.py:21-40``) where ``torch.nn.Linear``
stores ``[out, in]``, so every linear weight (Llama's ``*_proj.weight``;
GPT's ``attn.qkv``, ``attn.proj``, ``mlp.fc`` and ``mlp.proj`` weights;
``lm_head.weight``) is transposed. Biases, embeddings and norm weights
and biases are copied as they are. A transposed ``attn.qkv`` weight keeps
the JAX output order, so its output still splits as ``[B, S, 3, H, D]``.
Qwen2-MoE's router weight (``mlp.gate.gate.weight``) is transposed too;
its stacked experts (``mlp.expert_{0,1,2}``, ``[E, in, out]``) are copied
as they are, the port keeping the JAX layout there. ERNIE's dense layers
carry Llama's keys and its MoE layers Qwen2-MoE's, so both rules apply to
it (its head is tied unless ``tie_word_embeddings=False``). The incubate
layers
(``FusedLinear``, ``FusedDropoutAdd``, ``FusedBiasDropoutResidualLayerNorm``,
``FusedMultiHeadAttention``, ``FusedFeedForward``,
``FusedTransformerEncoderLayer``, ``FusedMultiTransformer``, ``FusedEcMoe``)
keep JAX's names and Paddle's layouts throughout, so their state is copied
with no transposition.
"""

from __future__ import annotations

import numpy as np
import torch

from .ernie import Ernie, ErnieConfig
from .gpt import GPT, GPTConfig
from .llama import Llama, LlamaConfig
from .qwen2_moe import Qwen2Moe, Qwen2MoeConfig

__all__ = ["llama_from_jax_state", "gpt_from_jax_state",
           "qwen2_moe_from_jax_state", "ernie_from_jax_state",
           "incubate_from_jax_state"]

_LLAMA_LINEAR = ("_proj.weight", "lm_head.weight")
_GPT_LINEAR = ("attn.qkv.weight", "attn.proj.weight", "mlp.fc.weight",
               "mlp.proj.weight", "lm_head.weight")
_QWEN2_MOE_LINEAR = ("_proj.weight", "lm_head.weight", "mlp.gate.gate.weight")


def llama_from_jax_state(state, cfg: LlamaConfig, device=None,
                         dtype=torch.float32) -> Llama:
    """A port :class:`Llama` on ``device`` (default ``cuda``) holding the
    weights in ``state`` (name -> numpy array, the JAX model's keys)."""
    return _load(Llama(cfg, device=device, dtype=dtype, seed=None), state,
                 _LLAMA_LINEAR)


def gpt_from_jax_state(state, cfg: GPTConfig, device=None,
                       dtype=torch.float32) -> GPT:
    """A port :class:`GPT` on ``device`` (default ``cuda``) holding the
    weights in ``state`` (name -> numpy array, the JAX model's keys)."""
    return _load(GPT(cfg, device=device, dtype=dtype, seed=None), state,
                 _GPT_LINEAR)


def qwen2_moe_from_jax_state(state, cfg: Qwen2MoeConfig, device=None,
                             dtype=torch.float32) -> Qwen2Moe:
    """A port :class:`Qwen2Moe` on ``device`` (default ``cuda``) holding the
    weights in ``state`` (name -> numpy array, the JAX model's keys)."""
    return _load(Qwen2Moe(cfg, device=device, dtype=dtype, seed=None), state,
                 _QWEN2_MOE_LINEAR)


def ernie_from_jax_state(state, cfg: ErnieConfig, device=None,
                         dtype=torch.float32) -> Ernie:
    """A port :class:`Ernie` on ``device`` (default ``cuda``) holding the
    weights in ``state`` (name -> numpy array, the JAX model's keys): the
    dense layers' projections and an untied ``lm_head`` transposed, the MoE
    layers' routers transposed and their stacked experts copied as they
    are."""
    return _load(Ernie(cfg, device=device, dtype=dtype, seed=None), state,
                 _QWEN2_MOE_LINEAR)


def incubate_from_jax_state(module, state):
    """Copy a JAX incubate layer's ``state_dict()`` (numpy arrays, the same
    keys) into the port's ``module`` in place, with no transposition; missing
    or extra keys raise. Returns ``module``."""
    return _load(module, state, ())


def _load(model, state, linear_suffixes):
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"state does not fit the config: missing {missing}, "
                       f"unexpected {extra}")
    with torch.no_grad():
        for name, param in own.items():
            arr = np.asarray(state[name])
            if name.endswith(linear_suffixes):
                arr = arr.T
            if arr.shape != tuple(param.shape):
                raise ValueError(f"{name}: shape {arr.shape} (after layout "
                                 f"change) != {tuple(param.shape)}")
            param.copy_(torch.tensor(arr))
    return model
