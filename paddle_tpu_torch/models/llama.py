"""Llama-3 style decoder-only LM (counterpart of ``paddle_tpu/models/llama.py``).

RMSNorm, rotate-half RoPE, SwiGLU MLP and grouped-query attention as
``torch.nn`` modules. Module names match the JAX model's ``state_dict()``
keys (``embed_tokens.weight``, ``layers.{i}.self_attn.q_proj.weight``, ...,
``norm.weight``, ``lm_head.weight``); ``models/convert.py`` carries a JAX
model's weights across. The modules hold the weights and the per-op
pieces the serving model (``serving/model.py``) strings together.
:meth:`Llama.forward` is the causal whole-sequence forward, with the loss
when ``labels`` are given. ``Llama.fused_blocks`` (default True, the
counterpart of ``FLAGS_use_fused_blocks``) picks the fused trunk (flash
attention, block epilogues) or the layer loop of the JAX escape hatch
(``fused_blocks = False``); both train through the backward kernels, the
fused trunk through the block-epilogue backward at every junction.
``init_cache`` and ``forward(caches=, cache_pos=)`` decode incrementally
on either trunk, and :meth:`generate` (``models/generation.py``) runs on
them; the cache is per-layer page pools read by the mmha kernel, not
JAX's contiguous buffers (see ``generation.py``). Linear weights are
stored ``[out, in]`` as ``torch.nn.Linear`` keeps them (the JAX package
stores ``[in, out]``).

Parameters are made on the target device and drawn from a seeded
``torch.Generator`` with the JAX init's std: ``initializer_range`` for
embeddings and projections, ``initializer_range / sqrt(2 * num_layers)``
for ``o_proj`` and ``down_proj``, ones for the norms.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..nn import functional as F
from .generation import (GenerationMixin, cache_index, cached_attention,
                         init_kv_pages)

__all__ = ["LlamaConfig", "Llama", "llama_tiny", "llama3_8b", "rope_tables"]


@dataclass
class LlamaConfig:
    vocab_size: int = 128256
    max_position_embeddings: int = 8192
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8          # GQA
    intermediate_size: int = 14336
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def rope_tables(cfg: LlamaConfig, seq_len: int, device=None):
    """f32 ``(cos, sin)`` ``[seq_len, head_dim]`` for rotate-half RoPE,
    computed in float64 as the JAX package does, then cast."""
    d = cfg.head_dim
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, d, 2, dtype=np.float64) / d))
    ang = np.outer(np.arange(seq_len, dtype=np.float64), inv)
    cos = np.concatenate([np.cos(ang), np.cos(ang)], axis=-1).astype(np.float32)
    sin = np.concatenate([np.sin(ang), np.sin(ang)], axis=-1).astype(np.float32)
    return (torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device))


class RMSNorm(nn.Module):
    def __init__(self, hidden: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(hidden))
        self.eps = eps

    def forward(self, x, plain=False):
        return F.rms_norm(x, self.weight, self.eps, plain=plain)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.n_head = cfg.num_heads
        self.n_kv = cfg.num_kv_heads
        self.head_dim = cfg.head_dim
        h = cfg.hidden_size
        self.q_proj = nn.Linear(h, cfg.num_heads * cfg.head_dim, bias=False)
        self.k_proj = nn.Linear(h, cfg.num_kv_heads * cfg.head_dim, bias=False)
        self.v_proj = nn.Linear(h, cfg.num_kv_heads * cfg.head_dim, bias=False)
        self.o_proj = nn.Linear(cfg.num_heads * cfg.head_dim, h, bias=False)

    def qkv(self, x):
        """``(q [B,S,H,D], k [B,S,Hkv,D], v [B,S,Hkv,D])`` of ``x [B,S,hidden]``."""
        b, s, _ = x.shape
        return (self.q_proj(x).reshape(b, s, self.n_head, self.head_dim),
                self.k_proj(x).reshape(b, s, self.n_kv, self.head_dim),
                self.v_proj(x).reshape(b, s, self.n_kv, self.head_dim))

    def forward(self, x, cos, sin, plain=False, cache=None, cache_pos=None,
                index=None):
        """Causal self-attention of ``x [B, S, hidden]``: projections, RoPE,
        flash attention over the shared kv heads, ``o_proj``
        (``paddle_tpu/models/llama.py:155-170``). With a ``cache`` (a
        layer's ``(k, v)`` page pools) the S positions from ``cache_pos``
        attend through :func:`~.generation.cached_attention` and the
        return is ``(out, cache)``."""
        b, s, _ = x.shape
        q, k, v = self.qkv(x)
        q, k = F.rope(q, k, sin, cos, plain=plain)
        if cache is not None:
            out = cached_attention(q, k, v, cache, cache_pos, index, plain)
            return self.o_proj(
                out.reshape(b, s, self.n_head * self.head_dim)), cache
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                             plain=plain)
        return self.o_proj(out.reshape(b, s, self.n_head * self.head_dim))


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        h, m = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = nn.Linear(h, m, bias=False)
        self.up_proj = nn.Linear(h, m, bias=False)
        self.down_proj = nn.Linear(m, h, bias=False)

    def forward(self, x, plain=False):
        return self.down_proj(F.swiglu(self.gate_proj(x), self.up_proj(x),
                                       plain=plain))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = LlamaAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps)
        self.mlp = LlamaMLP(cfg)

    def forward(self, x, cos, sin, plain=False, cache=None, cache_pos=None,
                index=None):
        """One layer of the unfused trunk (``paddle_tpu/models/llama.py:
        211-224``): ``x + attn(norm(x))`` through the fused residual-add
        norm, then ``h + mlp(y)``; ``(out, cache)`` with a ``cache``."""
        normed = self.input_layernorm(x, plain)
        if cache is not None:
            a, cache = self.self_attn(normed, cos, sin, plain, cache,
                                      cache_pos, index)
        else:
            a = self.self_attn(normed, cos, sin, plain)
        post = self.post_attention_layernorm
        y, h = F.fused_rms_norm_add(a, x, post.weight, post.eps, plain=plain)
        out = h + self.mlp(y, plain)
        return (out, cache) if cache is not None else out


class Llama(GenerationMixin, nn.Module):
    """Llama LM on ``device`` (default ``cuda``) in ``dtype``. ``seed``
    seeds the init generator; ``seed=None`` leaves the parameters
    uninitialised, for a caller that loads them."""

    def __init__(self, cfg: LlamaConfig, device=None, dtype=torch.float32,
                 seed: int | None = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        with torch.device("meta"):
            self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
            self.layers = nn.ModuleList(
                [self._make_layer(i) for i in range(cfg.num_layers)])
            self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
            self.lm_head = None if cfg.tie_word_embeddings else \
                nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)
        self.to(dtype)              # still on meta: no memory yet
        self.to_empty(device=dev)
        self._rope_cache: dict[int, tuple] = {}
        #: the fused trunk (block epilogues at every junction) or the layer
        #: loop; both have a backward
        self.fused_blocks = True
        if seed is not None:
            self.init_weights(seed)

    def _make_layer(self, i: int) -> nn.Module:
        """Decoder layer ``i`` (made on ``meta``; ERNIE's MoE tail
        overrides this)."""
        return LlamaDecoderLayer(self.cfg)

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.weight.device

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        std = self.cfg.initializer_range
        std_out = std / math.sqrt(2 * self.cfg.num_layers)
        for name, p in self.named_parameters():
            if name.endswith("layernorm.weight") or name == "norm.weight":
                p.fill_(1.0)
            elif name.endswith(("o_proj.weight", "down_proj.weight")):
                p.normal_(0.0, std_out, generator=gen)
            else:
                p.normal_(0.0, std, generator=gen)

    def rope(self, seq_len: int):
        """Memoized f32 ``(cos, sin)`` ``[seq_len, head_dim]`` on the model's
        device."""
        hit = self._rope_cache.get(seq_len)
        if hit is None:
            hit = self._rope_cache[seq_len] = rope_tables(self.cfg, seq_len,
                                                          self.device)
        return hit

    def _head(self, x, plain=False, normed=False):
        """Final norm + (tied) projection; ``normed`` skips the norm (the
        fused trunk folds it into the last junction)."""
        if not normed:
            x = self.norm(x, plain)
        if self.lm_head is None:
            return x @ self.embed_tokens.weight.t()
        return self.lm_head(x)

    def _fused_trunk(self, x, cos, sin, plain=False, caches=None,
                     cache_pos=None, index=None):
        """Both residual junctions of every layer — attention output ->
        ``post_attention_layernorm`` and MLP output -> the next layer's
        ``input_layernorm`` (the final norm after the last layer) — as one
        block-epilogue pass each. Returns the final-norm output
        (``paddle_tpu/models/llama.py:267-290``); with ``caches`` each
        layer attends through its cache."""
        layers = list(self.layers)
        y = layers[0].input_layernorm(x, plain)
        h = x
        for i, layer in enumerate(layers):
            if caches is None:
                a = layer.self_attn(y, cos, sin, plain)
            else:
                a, _ = layer.self_attn(y, cos, sin, plain, caches[i],
                                       cache_pos, index)
            post = layer.post_attention_layernorm
            y, h = F.fused_dropout_add_norm(a, h, post.weight, None, p=0.0,
                                            epsilon=post.eps, plain=plain)
            nxt = layers[i + 1].input_layernorm if i + 1 < len(layers) \
                else self.norm
            y, h = F.fused_dropout_add_norm(layer.mlp(y, plain), h,
                                            nxt.weight, None, p=0.0,
                                            epsilon=nxt.eps, plain=plain)
        return y

    def init_cache(self, batch, max_len, dtype=None):
        """Zeroed per-layer ``(k, v)`` page pools for incremental decoding
        (``paddle_tpu/models/llama.py:292``), ``[batch * T / 16, Hkv, 16,
        D]`` with ``T`` = ``max_len`` rounded up to 16, in ``dtype``
        (default: the model's), on the model's device."""
        cfg = self.cfg
        return init_kv_pages(len(self.layers), batch, max_len,
                             cfg.num_kv_heads, cfg.head_dim,
                             dtype or self.embed_tokens.weight.dtype,
                             self.device)

    def _cached_forward(self, input_ids, caches, cache_pos, with_head,
                        plain):
        """``(logits or None, caches)`` of ``input_ids [B, S]`` at positions
        ``cache_pos ..`` against ``caches`` (``paddle_tpu/models/
        llama.py:300-317``), on the trunk ``fused_blocks`` picks."""
        b, s = input_ids.shape
        start = int(cache_pos or 0)
        cos_t, sin_t = self.rope(self.cfg.max_position_embeddings)
        cos, sin = cos_t[start:start + s], sin_t[start:start + s]
        index = cache_index(caches[0], b, start, s)
        x = self.embed_tokens(input_ids.long())
        if self.fused_blocks and len(self.layers):
            out = self._fused_trunk(x, cos, sin, plain, caches, start, index)
        else:
            for layer, c in zip(self.layers, caches):
                x, _ = layer(x, cos, sin, plain, c, start, index)
            out = x
        if not with_head:
            return None, caches
        return self._head(out, plain, normed=self.fused_blocks
                          and len(self.layers) > 0), caches

    def forward(self, input_ids, labels=None, plain=False, caches=None,
                cache_pos=None, with_head=True):
        """Logits ``[B, S, vocab]`` of ``input_ids [B, S]``, or ``(logits,
        loss)`` with ``labels [B, S]``: the causal whole-sequence forward
        (``paddle_tpu/models/llama.py:300-331``), through the fused trunk
        or, with ``fused_blocks = False``, the layer loop. The loss is the
        mean cross entropy of the logits taken to f32 (``ignore_index``
        -100), as the JAX package computes it. ``plain=True`` runs every
        kernel's plain version, forward and backward. With ``caches``
        (:meth:`init_cache`) the S tokens sit at positions ``cache_pos ..``
        and the return is ``(logits, caches)``; ``with_head=False`` skips
        the head (``None`` in place of the logits)."""
        if caches is not None:
            return self._cached_forward(input_ids, caches, cache_pos,
                                        with_head, plain)
        cos, sin = self.rope(input_ids.shape[1])
        x = self.embed_tokens(input_ids.long())
        if self.fused_blocks:
            logits = self._head(self._fused_trunk(x, cos, sin, plain), plain,
                                normed=True)
        else:
            for layer in self.layers:
                x = layer(x, cos, sin, plain)
            logits = self._head(x, plain)
        if labels is None:
            return logits
        loss = F.cross_entropy(
            logits.reshape(-1, self.cfg.vocab_size).float(),
            labels.reshape(-1))
        return logits, loss


def llama_tiny(device=None, dtype=torch.float32, seed=0, **kw) -> Llama:
    cfg = dict(vocab_size=512, max_position_embeddings=128, hidden_size=64,
               num_layers=2, num_heads=4, num_kv_heads=2,
               intermediate_size=128)
    cfg.update(kw)
    return Llama(LlamaConfig(**cfg), device=device, dtype=dtype, seed=seed)


def llama3_8b(device=None, dtype=torch.bfloat16, seed=0, **kw) -> Llama:
    return Llama(LlamaConfig(**kw), device=device, dtype=dtype, seed=seed)
