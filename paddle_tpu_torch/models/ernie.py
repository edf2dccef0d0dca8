"""ERNIE-4.5 style decoder LM (counterpart of ``paddle_tpu/models/ernie.py``).

A GQA decoder with SwiGLU MLPs where dense layers lead and MoE layers with
a shared expert follow (``first_k_dense``), tied or untied embeddings; with
``num_experts == 0`` every layer is dense. The dense layers are the port's
``LlamaDecoderLayer`` and the MoE tail its ``Qwen2MoeDecoderLayer``, as in
JAX (:104-110), so the module names, and the ``state_dict`` keys, are
those of the JAX model (``models/convert.py`` ``ernie_from_jax_state``).

:class:`Ernie` is the port's :class:`~.llama.Llama` with ERNIE's config and
layers: a dense model runs Llama's fused trunk (flash attention and the
block epilogues, forward and backward), its page-pool cache
(``init_cache``, ``forward(caches=, cache_pos=)``), cached ``generate`` and
the serving engine. A model with a MoE tail runs the layer loop of the JAX
forward (:154-178), adds ``router_aux_loss_coef * l_aux`` to the loss, has
no cache (``init_cache`` is None, so ``generate`` takes the exact-length
host loop: capacity routing is not causal) and raises on a cached call.

Not ported: ``ernie_for_pipeline`` and ``ErnieMoeBlockPipe`` (:190-258),
which need the pipeline stack.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..nn import functional as F
from .llama import Llama, LlamaConfig, LlamaDecoderLayer
from .qwen2_moe import Qwen2MoeConfig, Qwen2MoeDecoderLayer, init_moe_weights

__all__ = ["ErnieConfig", "Ernie", "ErniePretrainLoss", "ernie_tiny"]


@dataclass
class ErnieConfig:
    vocab_size: int = 103424
    max_position_embeddings: int = 131072
    hidden_size: int = 2560
    num_layers: int = 28
    num_heads: int = 20
    num_kv_heads: int = 4
    intermediate_size: int = 12288
    # MoE tail (ERNIE-4.5: dense first k layers, MoE after); num_experts=0
    # gives the fully dense ERNIE 3.0-style backbone
    num_experts: int = 0
    num_experts_per_tok: int = 6
    moe_intermediate_size: int = 1536
    shared_expert_intermediate_size: int = 1536
    first_k_dense: int = 3
    router_aux_loss_coef: float = 0.001
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    initializer_range: float = 0.02
    tie_word_embeddings: bool = True

    def __post_init__(self):
        if self.num_experts and self.num_experts_per_tok > self.num_experts:
            raise ValueError(
                f"num_experts_per_tok ({self.num_experts_per_tok}) cannot "
                f"exceed num_experts ({self.num_experts})")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def as_llama(self) -> LlamaConfig:
        return LlamaConfig(
            vocab_size=self.vocab_size,
            max_position_embeddings=self.max_position_embeddings,
            hidden_size=self.hidden_size, num_layers=self.num_layers,
            num_heads=self.num_heads, num_kv_heads=self.num_kv_heads,
            intermediate_size=self.intermediate_size,
            rms_norm_eps=self.rms_norm_eps, rope_theta=self.rope_theta,
            initializer_range=self.initializer_range,
            tie_word_embeddings=self.tie_word_embeddings)

    def as_moe(self) -> Qwen2MoeConfig:
        return Qwen2MoeConfig(
            vocab_size=self.vocab_size,
            max_position_embeddings=self.max_position_embeddings,
            hidden_size=self.hidden_size, num_layers=self.num_layers,
            num_heads=self.num_heads, num_kv_heads=self.num_kv_heads,
            moe_intermediate_size=self.moe_intermediate_size,
            shared_expert_intermediate_size=(
                self.shared_expert_intermediate_size),
            num_experts=self.num_experts,
            num_experts_per_tok=self.num_experts_per_tok,
            first_k_dense_replace=self.first_k_dense,
            dense_intermediate_size=self.intermediate_size,
            router_aux_loss_coef=self.router_aux_loss_coef,
            rms_norm_eps=self.rms_norm_eps, rope_theta=self.rope_theta,
            initializer_range=self.initializer_range)


class Ernie(Llama):
    """ERNIE LM on ``device`` (default ``cuda``) in ``dtype``. ``seed``
    seeds the init generator; ``seed=None`` leaves the parameters
    uninitialised, for a caller that loads them. ``l_aux`` holds the MoE
    layers' summed load-balance loss after a forward (None when dense)."""

    def __init__(self, cfg: ErnieConfig, device=None, dtype=torch.float32,
                 seed: int | None = 0):
        self._moe_cfg = cfg.as_moe() if cfg.num_experts else None
        super().__init__(cfg, device=device, dtype=dtype, seed=seed)
        self.l_aux = None
        if cfg.num_experts:
            self.init_cache = None  # MoE: generate() must not cache

    def _make_layer(self, i: int) -> nn.Module:
        if self._moe_cfg is not None and i >= self.cfg.first_k_dense:
            return Qwen2MoeDecoderLayer(self._moe_cfg, i)
        return LlamaDecoderLayer(self.cfg)

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        init_moe_weights(self, seed)

    def forward(self, input_ids, labels=None, plain=False, caches=None,
                cache_pos=None, with_head=True):
        """Logits ``[B, S, vocab]``, or ``(logits, loss)`` with ``labels``;
        with ``caches`` (dense only) ``(logits, caches)``, as
        :meth:`Llama.forward`. The loss is the mean f32 cross entropy plus,
        with a MoE tail, ``router_aux_loss_coef * l_aux``."""
        if caches is not None and self.cfg.num_experts:
            raise ValueError(
                "MoE ERNIE cannot decode over a KV cache: per-token "
                "capacity routing is not causal, so incremental "
                "logits would silently diverge from the full forward")
        if not self.cfg.num_experts:
            self.l_aux = None
            return super().forward(input_ids, labels, plain, caches,
                                   cache_pos, with_head)
        cos, sin = self.rope(input_ids.shape[1])
        x = self.embed_tokens(input_ids.long())
        auxes = []
        for layer in self.layers:
            x = layer(x, cos, sin, plain)
            aux = getattr(layer, "l_aux", None)
            if aux is not None:
                auxes.append(aux)
        logits = self._head(x, plain)
        self.l_aux = sum(auxes[1:], auxes[0]) if auxes else None
        if labels is None:
            return logits
        loss = F.cross_entropy(
            logits.reshape(-1, self.cfg.vocab_size).float(),
            labels.reshape(-1))
        if self.l_aux is not None:
            loss = loss + self.cfg.router_aux_loss_coef * self.l_aux
        return logits, loss

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def flops_per_token(self, seq_len: int) -> float:
        n = self.num_params()
        l, h = self.cfg.num_layers, self.cfg.hidden_size
        return 6.0 * n + 12.0 * l * h * seq_len / 2


class ErniePretrainLoss(nn.Module):
    """The mean f32 cross entropy of ``logits`` over ``[-1, vocab]`` (JAX's
    ``GPTPretrainLoss``, ``paddle_tpu/models/gpt_hybrid.py:119-127``)."""

    def __init__(self, cfg):
        super().__init__()
        self.vocab_size = cfg.vocab_size

    def forward(self, logits, labels):
        return F.cross_entropy(
            logits.reshape(-1, self.vocab_size).float(), labels.reshape(-1))


def ernie_tiny(device=None, dtype=torch.float32, seed=0, **kw) -> Ernie:
    cfg = dict(vocab_size=256, max_position_embeddings=64, hidden_size=32,
               num_layers=2, num_heads=4, num_kv_heads=2,
               intermediate_size=64)
    cfg.update(kw)
    return Ernie(ErnieConfig(**cfg), device=device, dtype=dtype, seed=seed)
