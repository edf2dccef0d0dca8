"""Qwen2-MoE / DeepSeekMoE decoder LM (counterpart of
``paddle_tpu/models/qwen2_moe.py``).

Llama blocks whose MLP is the routed :class:`MoELayer` (60 experts of
1408, top-4, and a shared expert of 5632 at the default
``Qwen2MoeConfig()``, the published Qwen1.5-MoE-A2.7B widths), and, for
DeepSeekMoE's ``first_k_dense_replace``, dense SwiGLU MLPs in the first
layers. :class:`Qwen2MoeDecoderLayer` subclasses the port's
``LlamaDecoderLayer`` and swaps its ``mlp``, so attention, RoPE and the
residual-add norm run as on Llama's layer loop (there is no fused trunk,
as in JAX). The layers' load-balance losses are summed into ``l_aux`` and
added to the loss scaled by ``router_aux_loss_coef``. ``generate`` is the
exact-length host loop of ``models/generation.py``.

The JAX model always renormalises the top-k weights and has no q/k/v bias
and no gate on the shared expert; the published model has all three
(``norm_topk_prob: false``). The port follows the JAX package.

Parameters are made on ``meta``, allocated on the target device and drawn
from a seeded ``torch.Generator`` with the JAX init's std:
``initializer_range`` for the embedding, the projections and every
gate/up projection (the experts' ``expert_0`` / ``expert_1`` too),
``initializer_range / sqrt(2 * num_layers)`` for ``o_proj`` and every
``down_proj`` (``expert_2``), XavierNormal and a zero bias for the router
(``mlp.gate.gate``), ones for the norms. Linear weights are ``[out, in]``
except the stacked experts, which keep the JAX package's ``[E, in, out]``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from ..device import resolve_device
from ..incubate.distributed.models.moe import MoELayer
from ..nn import functional as F
from .generation import GenerationMixin
from .llama import LlamaConfig, LlamaDecoderLayer, RMSNorm, rope_tables

__all__ = ["Qwen2MoeConfig", "Qwen2Moe", "Qwen2MoeDecoderLayer",
           "qwen2_moe_tiny", "deepseek_moe"]


@dataclass
class Qwen2MoeConfig:
    vocab_size: int = 151936
    max_position_embeddings: int = 8192
    hidden_size: int = 2048
    num_layers: int = 24
    num_heads: int = 16
    num_kv_heads: int = 16
    moe_intermediate_size: int = 1408   # per-expert ffn width
    shared_expert_intermediate_size: int = 5632
    num_experts: int = 60
    num_experts_per_tok: int = 4
    first_k_dense_replace: int = 0      # DeepSeekMoE: dense first k layers
    dense_intermediate_size: int = 5632
    router_aux_loss_coef: float = 0.001
    capacity_factor: float = 2.0
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    initializer_range: float = 0.02
    expert_parallel_axis: str = "dp"

    def __post_init__(self):
        # layers past first_k_dense_replace are always MoE
        if self.num_experts <= 0:
            raise ValueError(
                f"Qwen2Moe needs num_experts >= 1, got {self.num_experts} "
                "(the dense variant is LlamaConfig / ErnieConfig with "
                "num_experts=0)")
        if self.num_experts_per_tok > self.num_experts:
            raise ValueError(
                f"num_experts_per_tok ({self.num_experts_per_tok}) cannot "
                f"exceed num_experts ({self.num_experts}) — the router's "
                "top-k has nothing to select from")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def as_llama(self) -> LlamaConfig:
        return LlamaConfig(
            vocab_size=self.vocab_size,
            max_position_embeddings=self.max_position_embeddings,
            hidden_size=self.hidden_size, num_layers=self.num_layers,
            num_heads=self.num_heads, num_kv_heads=self.num_kv_heads,
            intermediate_size=self.dense_intermediate_size,
            rms_norm_eps=self.rms_norm_eps, rope_theta=self.rope_theta,
            initializer_range=self.initializer_range)


class _SwiGLU(nn.Module):
    """``down(swiglu(gate(x), up(x)))``: an expert, the shared expert or a
    dense layer's MLP. Off ``meta`` its weights are drawn from the default
    generator with the JAX init's std."""

    def __init__(self, h, m, init_range=0.02, n_layers=1):
        super().__init__()
        self.gate_proj = nn.Linear(h, m, bias=False)
        self.up_proj = nn.Linear(h, m, bias=False)
        self.down_proj = nn.Linear(m, h, bias=False)
        if self.gate_proj.weight.device.type != "meta":
            with torch.no_grad():
                self.gate_proj.weight.normal_(0.0, init_range)
                self.up_proj.weight.normal_(0.0, init_range)
                self.down_proj.weight.normal_(
                    0.0, init_range / math.sqrt(2 * n_layers))

    def forward(self, x, plain=False):
        return self.down_proj(F.swiglu(self.gate_proj(x), self.up_proj(x),
                                       plain=plain))


class Qwen2MoeDecoderLayer(LlamaDecoderLayer):
    """The port's ``LlamaDecoderLayer`` with the MLP swapped for the routed
    MoE block, or for a dense SwiGLU before ``first_k_dense_replace``."""

    def __init__(self, cfg: Qwen2MoeConfig, layer_idx: int):
        super().__init__(cfg.as_llama())
        h, r, n_l = cfg.hidden_size, cfg.initializer_range, cfg.num_layers
        self.is_dense = layer_idx < cfg.first_k_dense_replace
        if self.is_dense:
            self.mlp = _SwiGLU(h, cfg.dense_intermediate_size, r, n_l)
        else:
            experts = [_SwiGLU(h, cfg.moe_intermediate_size, r, n_l)
                       for _ in range(cfg.num_experts)]
            shared = None
            if cfg.shared_expert_intermediate_size:
                shared = _SwiGLU(h, cfg.shared_expert_intermediate_size, r,
                                 n_l)
            self.mlp = MoELayer(
                d_model=h, experts=experts,
                gate={"type": "gshard", "top_k": cfg.num_experts_per_tok},
                capacity_factor=cfg.capacity_factor,
                expert_parallel_axis=cfg.expert_parallel_axis,
                shared_experts=shared)

    @property
    def l_aux(self):
        return None if self.is_dense else self.mlp.l_aux


@torch.no_grad()
def init_moe_weights(model, seed: int) -> None:
    """Draw ``model``'s parameters from a generator seeded with ``seed``,
    with the JAX init's std (the module docstring); ``model.cfg`` gives
    ``initializer_range``, ``num_layers``, ``hidden_size`` and
    ``num_experts``."""
    gen = torch.Generator(device=model.device).manual_seed(int(seed))
    cfg = model.cfg
    std = cfg.initializer_range
    std_out = std / math.sqrt(2 * cfg.num_layers)
    std_gate = math.sqrt(2.0 / (cfg.hidden_size + cfg.num_experts))
    for name, p in model.named_parameters():
        if name.endswith("layernorm.weight") or name == "norm.weight":
            p.fill_(1.0)
        elif name.endswith("mlp.gate.gate.bias"):
            p.zero_()
        elif name.endswith("mlp.gate.gate.weight"):
            p.normal_(0.0, std_gate, generator=gen)
        elif name.endswith(("o_proj.weight", "down_proj.weight",
                            "mlp.expert_2")):
            p.normal_(0.0, std_out, generator=gen)
        else:
            p.normal_(0.0, std, generator=gen)


class Qwen2Moe(GenerationMixin, nn.Module):
    """Qwen2-MoE LM on ``device`` (default ``cuda``) in ``dtype``. ``seed``
    seeds the init generator; ``seed=None`` leaves the parameters
    uninitialised, for a caller that loads them."""

    def __init__(self, cfg: Qwen2MoeConfig, device=None, dtype=torch.float32,
                 seed: int | None = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self._llama_cfg = cfg.as_llama()
        with torch.device("meta"):
            self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
            self.layers = nn.ModuleList(
                [Qwen2MoeDecoderLayer(cfg, i) for i in range(cfg.num_layers)])
            self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                     bias=False)
        self.to(dtype)              # still on meta: no memory yet
        self.to_empty(device=dev)
        self._rope_tables = None
        self.l_aux = None
        if seed is not None:
            self.init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.weight.device

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        init_moe_weights(self, seed)

    def rope(self, seq_len: int):
        """f32 ``(cos, sin)`` ``[seq_len, head_dim]`` on the model's device:
        the first rows of tables made once for ``max_position_embeddings``
        (or ``seq_len``, if longer). ``generate`` runs a new length every
        step; a table made per length would be copied from the host each
        time, and the copy waits for the card."""
        if self._rope_tables is None or \
                self._rope_tables[0].shape[0] < seq_len:
            self._rope_tables = rope_tables(
                self._llama_cfg,
                max(seq_len, self.cfg.max_position_embeddings), self.device)
        cos, sin = self._rope_tables
        return cos[:seq_len], sin[:seq_len]

    def forward(self, input_ids, labels=None, plain=False):
        """Logits ``[B, S, vocab]`` of ``input_ids [B, S]``, or ``(logits,
        loss)`` with ``labels``: the layer loop of
        ``paddle_tpu/models/qwen2_moe.py:152-170``. The loss is the mean
        cross entropy of the logits taken to f32 (``ignore_index`` -100)
        plus ``router_aux_loss_coef * l_aux``. ``plain=True`` runs every
        kernel's plain version, forward and backward."""
        cos, sin = self.rope(input_ids.shape[1])
        x = self.embed_tokens(input_ids.long())
        auxes = []
        for layer in self.layers:
            x = layer(x, cos, sin, plain)
            if layer.l_aux is not None:
                auxes.append(layer.l_aux)
        logits = self.lm_head(self.norm(x, plain))
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

    def num_activated_params(self) -> int:
        """Parameters a token touches: dense, shared and top-k experts."""
        total = self.num_params()
        for layer in self.layers:
            if not layer.is_dense:
                per_expert = sum(p.numel() for p in layer.mlp.stacked) \
                    // self.cfg.num_experts
                inactive = self.cfg.num_experts - self.cfg.num_experts_per_tok
                total -= per_expert * inactive
        return total

    def flops_per_token(self, seq_len: int) -> float:
        """6 * activated parameters + the causal attention term."""
        n = self.num_activated_params()
        l, h = self.cfg.num_layers, self.cfg.hidden_size
        return 6.0 * n + 12.0 * l * h * seq_len / 2


def qwen2_moe_tiny(device=None, dtype=torch.float32, seed=0, **kw) -> Qwen2Moe:
    cfg = dict(vocab_size=256, max_position_embeddings=64, hidden_size=32,
               num_layers=2, num_heads=4, num_kv_heads=2,
               moe_intermediate_size=32, shared_expert_intermediate_size=64,
               num_experts=4, num_experts_per_tok=2)
    cfg.update(kw)
    return Qwen2Moe(Qwen2MoeConfig(**cfg), device=device, dtype=dtype,
                    seed=seed)


def deepseek_moe(device=None, dtype=torch.float32, seed=0, **kw) -> Qwen2Moe:
    """DeepSeekMoE flavour: a dense first layer, many small experts."""
    cfg = dict(first_k_dense_replace=1, num_experts=64,
               num_experts_per_tok=6, moe_intermediate_size=1408,
               shared_expert_intermediate_size=2816)
    cfg.update(kw)
    return Qwen2Moe(Qwen2MoeConfig(**cfg), device=device, dtype=dtype,
                    seed=seed)
