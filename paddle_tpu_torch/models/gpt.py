"""GPT-2 style decoder-only LM (counterpart of ``paddle_tpu/models/gpt.py``,
the JAX package's flagship model: BASELINE.md config #1).

Layer norm with a bias, learned position embeddings, causal flash
attention, a tanh-gelu MLP and embeddings tied to the head, as
``torch.nn`` modules. Module names match the JAX model's ``state_dict()``
keys (``wte.weight``, ``wpe.weight``, ``blocks.{i}.ln1.weight``,
``blocks.{i}.attn.qkv.weight``, ..., ``ln_f.bias``); ``models/convert.py``
``gpt_from_jax_state`` carries a JAX model's weights across. Linear
weights are stored ``[out, in]`` as ``torch.nn.Linear`` keeps them (the
JAX package stores ``[in, out]``).

:meth:`GPT.forward` is the causal whole-sequence forward, with the loss
when ``labels`` are given. ``GPT.fused_blocks`` (default True, the
counterpart of ``FLAGS_use_fused_blocks``) runs the fused trunk
(``gpt.py:153-177``): every residual junction is one block-epilogue pass,
layer norm with its bias, forward and backward through the kernels; with
``fused_blocks = False`` it runs the layer loop (``gpt.py:96-105``).

``init_cache`` and ``forward(caches=, cache_pos=)`` decode incrementally
(``gpt.py:57-101, 123, 179-193``) on either trunk, and :meth:`GPT.generate`
(``models/generation.py``) runs on them; the cache is per-layer page pools
read by the mmha kernel (H = Hkv, D 64 at GPT-2 small's width), not JAX's
contiguous buffers.

Not ported, and raising: dropout in training (``GPTConfig(dropout > 0)``:
the JAX model draws its attention and embedding dropout bits from
``jax.random``, which no kernel here can reproduce bit for bit).

Parameters are made on the target device and drawn from a seeded
``torch.Generator`` with the JAX init's std: ``initializer_range`` for the
embeddings, ``qkv`` and ``fc``, ``initializer_range / sqrt(2 *
num_layers)`` for both ``proj``s; zero biases; ones and zeros for the
layer norms.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from ..device import resolve_device
from ..nn import functional as F
from .generation import (GenerationMixin, cache_index, cached_attention,
                         init_kv_pages)

__all__ = ["GPTConfig", "GPT", "gpt2_small", "gpt2_tiny"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304  # 50257 padded to a multiple of 128
    max_position_embeddings: int = 1024
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int | None = None
    dropout: float = 0.0
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    tie_word_embeddings: bool = True

    @property
    def ffn_size(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size


class LayerNorm(nn.Module):
    def __init__(self, hidden: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(hidden))
        self.bias = nn.Parameter(torch.empty(hidden))
        self.eps = eps

    def forward(self, x):
        return F.layer_norm(x, None, self.weight, self.bias, self.eps)


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.n_head = cfg.num_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.qkv = nn.Linear(cfg.hidden_size, 3 * cfg.hidden_size)
        self.proj = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, x, plain=False, cache=None, cache_pos=None,
                index=None):
        """Causal self-attention of ``x [B, S, hidden]``: the qkv output
        splits as ``[B, S, 3, H, D]`` (``gpt.py:59-60``), then flash
        attention and ``proj``. With a ``cache`` (a layer's ``(k, v)`` page
        pools) the S positions from ``cache_pos`` attend through
        :func:`~.generation.cached_attention` and the return is ``(out,
        cache)``."""
        b, s, h = x.shape
        qkv = self.qkv(x).reshape(b, s, 3, self.n_head, self.head_dim)
        q, k, v = (t.contiguous() for t in qkv.unbind(2))
        if cache is not None:
            out = cached_attention(q, k, v, cache, cache_pos, index, plain)
            return self.proj(out.reshape(b, s, h)), cache
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                             plain=plain)
        return self.proj(out.reshape(b, s, h))


class MLP(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.fc = nn.Linear(cfg.hidden_size, cfg.ffn_size)
        self.proj = nn.Linear(cfg.ffn_size, cfg.hidden_size)

    def forward(self, x):
        return self.proj(F.gelu(self.fc(x), approximate=True))


class Block(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.ln1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_epsilon)
        self.attn = CausalSelfAttention(cfg)
        self.ln2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_epsilon)
        self.mlp = MLP(cfg)

    def forward(self, x, plain=False, cache=None, cache_pos=None,
                index=None):
        """One block of the layer loop (``gpt.py:96-105``); ``(out,
        cache)`` with a ``cache``."""
        if cache is not None:
            a, cache = self.attn(self.ln1(x), plain, cache, cache_pos, index)
            x = x + a
            return x + self.mlp(self.ln2(x)), cache
        x = x + self.attn(self.ln1(x), plain)
        return x + self.mlp(self.ln2(x))


class GPT(GenerationMixin, nn.Module):
    """GPT LM on ``device`` (default ``cuda``) in ``dtype``. ``seed`` seeds
    the init generator; ``seed=None`` leaves the parameters uninitialised,
    for a caller that loads them."""

    def __init__(self, cfg: GPTConfig, device=None, dtype=torch.float32,
                 seed: int | None = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        with torch.device("meta"):
            self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
            self.wpe = nn.Embedding(cfg.max_position_embeddings,
                                    cfg.hidden_size)
            self.blocks = nn.ModuleList(
                [Block(cfg) for _ in range(cfg.num_layers)])
            self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_epsilon)
            self.lm_head = None if cfg.tie_word_embeddings else \
                nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)
        self.to(dtype)              # still on meta: no memory yet
        self.to_empty(device=dev)
        #: the fused trunk (block epilogues at every junction) or the layer
        #: loop; both have a backward
        self.fused_blocks = True
        if seed is not None:
            self.init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        std = self.cfg.initializer_range
        std_out = std / math.sqrt(2 * self.cfg.num_layers)
        for name, p in self.named_parameters():
            if ".ln" in name or name.startswith("ln_f."):
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith(".bias"):
                p.zero_()
            elif name.endswith("proj.weight"):
                p.normal_(0.0, std_out, generator=gen)
            else:
                p.normal_(0.0, std, generator=gen)

    def _head(self, x, normed=False):
        """Final norm + (tied) projection; ``normed`` skips ``ln_f`` (the
        fused trunk folds it into the last junction)."""
        if not normed:
            x = self.ln_f(x)
        if self.lm_head is None:
            return x @ self.wte.weight.t()
        return self.lm_head(x)

    def _fused_trunk(self, x, plain=False, caches=None, cache_pos=None,
                     index=None):
        """Every residual junction — attention output -> ``ln2`` and MLP
        output -> the next block's ``ln1`` (``ln_f`` after the last) — as
        one block-epilogue pass each, layer norm with its bias. Returns the
        ``ln_f`` output (``gpt.py:153-177``); with ``caches`` each block
        attends through its cache."""
        blocks = list(self.blocks)
        y = blocks[0].ln1(x)
        h = x
        for i, blk in enumerate(blocks):
            if caches is None:
                a = blk.attn(y, plain)
            else:
                a, _ = blk.attn(y, plain, caches[i], cache_pos, index)
            y, h = F.fused_dropout_add_norm(
                a, h, blk.ln2.weight, blk.ln2.bias, p=0.0,
                epsilon=blk.ln2.eps, norm="layer", plain=plain)
            nxt = blocks[i + 1].ln1 if i + 1 < len(blocks) else self.ln_f
            y, h = F.fused_dropout_add_norm(
                blk.mlp(y), h, nxt.weight, nxt.bias, p=0.0,
                epsilon=nxt.eps, norm="layer", plain=plain)
        return y

    def init_cache(self, batch, max_len, dtype=None):
        """Zeroed per-layer ``(k, v)`` page pools for incremental decoding
        (``gpt.py:123``), ``[batch * T / 16, H, 16, D]`` with ``T`` =
        ``max_len`` rounded up to 16, in ``dtype`` (default: the model's),
        on the model's device."""
        cfg = self.cfg
        return init_kv_pages(len(self.blocks), batch, max_len,
                             cfg.num_heads, cfg.hidden_size // cfg.num_heads,
                             dtype or self.wte.weight.dtype, self.device)

    def _cached_forward(self, input_ids, caches, cache_pos, with_head,
                        plain):
        """``(logits or None, caches)`` of ``input_ids [B, S]`` at positions
        ``cache_pos ..`` against ``caches`` (``gpt.py:179-193``), on the
        trunk ``fused_blocks`` picks."""
        b, s = input_ids.shape
        start = int(cache_pos or 0)
        pos = torch.arange(start, start + s, device=input_ids.device)
        x = self.wte(input_ids.long()) + self.wpe(pos)[None]
        index = cache_index(caches[0], b, start, s)
        fused = self.fused_blocks and len(self.blocks) > 0
        if fused:
            out = self._fused_trunk(x, plain, caches, start, index)
        else:
            for blk, c in zip(self.blocks, caches):
                x, _ = blk(x, plain, c, start, index)
            out = x
        if not with_head:
            return None, caches
        return self._head(out, normed=fused), caches

    def forward(self, input_ids, labels=None, plain=False, caches=None,
                cache_pos=None, with_head=True):
        """Logits ``[B, S, vocab]`` of ``input_ids [B, S]``, or ``(logits,
        loss)`` with ``labels [B, S]``: the causal whole-sequence forward
        (``gpt.py:179-211``), through the fused trunk or, with
        ``fused_blocks = False``, the layer loop. The loss is the mean
        cross entropy of the logits taken to f32 (``ignore_index`` -100),
        as the JAX package computes it. ``plain=True`` runs every kernel's
        plain version, forward and backward. With ``caches``
        (:meth:`init_cache`) the S tokens sit at positions ``cache_pos ..``
        and the return is ``(logits, caches)``; ``with_head=False`` skips
        the head (``None`` in place of the logits)."""
        if self.training and self.cfg.dropout > 0.0:
            raise NotImplementedError(
                f"GPTConfig(dropout={self.cfg.dropout}) in training: the "
                f"JAX model draws its attention and embedding dropout from "
                f"jax.random, which the port cannot reproduce; train at "
                f"dropout=0.0 or call eval()")
        if caches is not None:
            return self._cached_forward(input_ids, caches, cache_pos,
                                        with_head, plain)
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)
        x = self.wte(input_ids.long()) + self.wpe(pos)[None]
        if self.fused_blocks and len(self.blocks):
            logits = self._head(self._fused_trunk(x, plain), normed=True)
        else:
            for blk in self.blocks:
                x = blk(x, plain)
            logits = self._head(x)
        if labels is None:
            return logits
        loss = F.cross_entropy(
            logits.reshape(-1, self.cfg.vocab_size).float(),
            labels.reshape(-1))
        return logits, loss

    def num_params(self, non_embedding=True) -> int:
        n = sum(p.numel() for p in self.parameters())
        if non_embedding:
            n -= self.wpe.weight.numel()
        return n

    def flops_per_token(self, seq_len: int) -> float:
        """Analytic FLOPs per token: 6N plus the attention term, causal
        (half the window), as ``gpt.py:219-223`` counts it."""
        n = self.num_params()
        lay, h = self.cfg.num_layers, self.cfg.hidden_size
        return 6.0 * n + 12.0 * lay * h * seq_len / 2


def gpt2_small(device=None, dtype=torch.float32, seed=0, **kw) -> GPT:
    return GPT(GPTConfig(**kw), device=device, dtype=dtype, seed=seed)


def gpt2_tiny(device=None, dtype=torch.float32, seed=0, **kw) -> GPT:
    cfg = dict(vocab_size=1024, max_position_embeddings=128, hidden_size=128,
               num_layers=2, num_heads=4)
    cfg.update(kw)
    return GPT(GPTConfig(**cfg), device=device, dtype=dtype, seed=seed)
