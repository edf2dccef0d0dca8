"""Text generation (counterpart of ``paddle_tpu/models/generation.py``).

A model with ``init_cache`` (Llama, GPT) decodes incrementally, the
counterpart of JAX's ``_cached_decode`` (:198): one prefill of the first
``s - 1`` prompt tokens at cache position 0, then one token a step, each
step a forward over the one new token against the model's KV cache. JAX
compiles that loop into one ``lax.while_loop``; PyTorch has no compiled
while-loop, so here it is a host loop over cached one-token forwards.

:func:`cached_attention` is the attention of those forwards, with JAX's
three cases (:112): a single token runs through the mmha kernel; a block
at cache position 0 (the prefill) is causal self-attention over its own
q, k and v, through the flash-attention kernel; any other block runs the
grouped-einsum composite against the cache.

The cache layout differs from JAX's on purpose. JAX's ``init_cache``
gives contiguous ``[B, Hkv, T, D]`` buffers; the port's mmha kernel reads
pages ``[P, Hkv, ps, D]`` through a page table. So ``init_cache`` returns,
per layer, a ``(k, v)`` pair of page pools ``[B * T / 16, Hkv, 16, D]``
(``T`` rounded up to 16) and row ``b`` owns pages ``b * T / 16`` onward:
:func:`cache_table` is that identity table, built once a forward with the
new positions' pages and slots (:func:`cache_index`), and :func:`cache_view`
gives the ``[B, Hkv, T, D]`` view of JAX's buffers.
The pools are written in place; a cached forward returns the same pairs.

A model without ``init_cache``, and a model holding a ``MoELayer``, takes
the exact-length host loop (``generation.py:255-287``): one whole forward
of the exact prefix per emitted token. Capacity routing is not causal, so
padding could evict real tokens of other rows; a MoE model always decodes
this way. ``use_cache=False`` runs it for any model.

Greedy decoding takes the argmax. Sampling divides by ``temperature``,
keeps the ``top_k`` largest logits and takes the Gumbel-max draw, from a
``torch.Generator`` seeded with ``seed``; an unseeded call takes the next
value of a process counter, as JAX's ``_seed_counter`` does (:30), never
wall-clock entropy. The bits are not ``jax.random``'s. A row that emits
``eos_token_id`` emits it for the rest of the buffer, and once every row
has, the loop stops and the tail is ``eos_token_id``.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

__all__ = ["GenerationMixin", "generate", "cached_attention",
           "init_kv_pages", "cache_table", "cache_index", "cache_view",
           "CACHE_PAGE"]

_seed_counter = itertools.count(1)

#: positions a page of a generation cache holds
CACHE_PAGE = 16


def init_kv_pages(n_layers, batch, max_len, n_kv, head_dim, dtype, device):
    """Zeroed per-layer ``(k, v)`` page pools ``[batch * T / 16, n_kv, 16,
    head_dim]`` in ``dtype`` (a torch dtype or its name, "float32"), ``T``
    = ``max_len`` rounded up to 16; row ``b`` owns pages ``b * T / 16 ..
    (b + 1) * T / 16 - 1``."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    pages = -(-int(max_len) // CACHE_PAGE)
    shape = (int(batch) * pages, n_kv, CACHE_PAGE, head_dim)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(n_layers)]


def cache_table(cache, batch):
    """The identity page table ``[batch, T / 16]`` int32 of a layer's
    ``(k, v)`` pools."""
    n = cache[0].shape[0]
    return torch.arange(n, dtype=torch.int32,
                        device=cache[0].device).reshape(batch, n // batch)


def cache_index(cache, batch, start, s):
    """What every layer of one cached forward shares, built once: the
    identity table, the page and slot of each new position (row-major
    ``[batch * s]``) and, for one token, its position a row (mmha's
    ``pos``)."""
    table = cache_table(cache, batch)
    pos = torch.arange(start, start + s, device=table.device)
    page = table[:, pos // CACHE_PAGE].reshape(-1).long()
    slot = (pos % CACHE_PAGE).repeat(batch)
    last = torch.full((batch,), start, dtype=torch.int32,
                      device=table.device)
    return table, page, slot, last


def cache_view(cache, batch):
    """A layer's ``(k, v)`` as contiguous ``[batch, Hkv, T, D]`` buffers,
    the layout of JAX's ``init_cache``."""
    from ..ops.kernels import mmha
    tab = cache_table(cache, batch)
    return mmha.gather_pages(cache[0], tab), mmha.gather_pages(cache[1], tab)


def cached_attention(q, k, v, cache, cache_pos, index=None, plain=False):
    """Attention of ``s`` new positions from ``cache_pos`` against the
    cache, after writing their keys and values into it (in place).

    q ``[B, s, H, D]``, k / v ``[B, s, Hkv, D]``; cache a ``(k, v)`` pair
    of page pools (:func:`init_kv_pages`); ``cache_pos`` an int; index the
    forward's :func:`cache_index` (built here when None). A single token
    runs the mmha kernel (on the CPU its plain version; ``plain=True`` too),
    a block at position 0 the flash-attention kernel over its own q, k and
    v, any other block the grouped-einsum composite over the gathered
    cache, key ``j`` visible to query ``i`` iff ``j <= cache_pos + i``.
    Returns ``[B, s, H, D]``."""
    from ..nn import functional as F
    from ..ops.kernels import mmha
    from ..serving import kv_cache

    kp, vp = cache
    b, s, h, d = q.shape
    start = int(cache_pos)
    table, page, slot, last = index if index is not None else \
        cache_index(cache, b, start, s)
    h_kv = kp.shape[1]
    kp[page, :, slot] = k.reshape(b * s, h_kv, d).to(kp.dtype)
    vp[page, :, slot] = v.reshape(b * s, h_kv, d).to(vp.dtype)
    if s == 1:
        fn = mmha.mmha_plain if plain else mmha.mmha_decode
        return fn(q.contiguous(), kp, vp, table, last)
    if start == 0:
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              plain=plain)
    return kv_cache.chunk_attention(q, mmha.gather_pages(kp, table),
                                    mmha.gather_pages(vp, table), start)


def _contains_moe(model) -> bool:
    from ..incubate.distributed.models.moe import MoELayer
    return any(isinstance(m, MoELayer) for m in model.modules())


def _next_tokens(logits, finished, gen, temperature, top_k, do_sample,
                 eos_token_id):
    arr = logits.float()
    if do_sample:
        arr = arr / max(temperature, 1e-6)
        if top_k is not None and top_k < arr.shape[-1]:
            kth = torch.topk(arr, top_k, dim=-1).values[:, -1:]
            arr = arr.masked_fill(arr < kth, float("-inf"))
        gumbel = -torch.empty_like(arr).exponential_(generator=gen).log()
        nxt = (arr + gumbel).argmax(-1)
    else:
        nxt = arr.argmax(-1)
    if eos_token_id is not None:
        nxt = torch.where(finished, eos_token_id, nxt)
        finished |= nxt == eos_token_id
    return nxt


def _generate_hostloop(model, buf, s, total, temperature, top_k,
                       do_sample, eos_token_id, gen):
    finished = torch.zeros(buf.shape[0], dtype=torch.bool, device=buf.device)
    for i in range(s, total):
        with torch.no_grad():
            logits = model(buf[:, :i])
        if isinstance(logits, tuple):
            logits = logits[0]
        buf[:, i] = _next_tokens(logits[:, -1, :], finished, gen,
                                 temperature, top_k, do_sample, eos_token_id)
        if eos_token_id is not None and bool(finished.all()):
            buf[:, i + 1:] = eos_token_id
            break
    return buf


def _generate_cached(model, buf, s, total, temperature, top_k, do_sample,
                     eos_token_id, gen):
    """JAX's ``_cached_decode`` as a host loop: prefill ``s - 1`` prompt
    tokens at position 0 (no head), then feed one token a step."""
    finished = torch.zeros(buf.shape[0], dtype=torch.bool, device=buf.device)
    caches = model.init_cache(buf.shape[0], total)
    with torch.no_grad():
        if s > 1:
            model(buf[:, :s - 1], caches=caches, cache_pos=0,
                  with_head=False)
        for i in range(s, total):
            logits, _ = model(buf[:, i - 1:i], caches=caches,
                              cache_pos=i - 1)
            buf[:, i] = _next_tokens(logits[:, 0, :], finished, gen,
                                     temperature, top_k, do_sample,
                                     eos_token_id)
            if eos_token_id is not None and bool(finished.all()):
                buf[:, i + 1:] = eos_token_id
                break
    return buf


def generate(model, input_ids, max_new_tokens=20, temperature=1.0,
             top_k=None, do_sample=False, eos_token_id=None, seed=None,
             use_cache=True):
    """``input_ids``: a ``[B, S]`` prompt (tensor, array or nested list).
    Returns an int64 ``[B, S + max_new_tokens]`` tensor on the model's
    device; a row that emits ``eos_token_id`` emits it for the rest of the
    buffer, and once every row has, the tail is ``eos_token_id``. A model
    with ``init_cache`` and no ``MoELayer`` decodes with its KV cache
    unless ``use_cache=False``; any other model, or ``use_cache=False``,
    takes the exact-length host loop."""
    if isinstance(input_ids, torch.Tensor):
        ids = input_ids.detach().to(torch.int64)
    else:
        ids = torch.from_numpy(np.asarray(input_ids).astype(np.int64))
    if ids.dim() != 2:
        raise ValueError(f"input_ids must be [B, S], got {tuple(ids.shape)}")
    b, s = ids.shape
    total = s + max_new_tokens
    max_pos = getattr(getattr(model, "cfg", None),
                      "max_position_embeddings", total)
    if total > max_pos:
        raise ValueError(f"prompt {s} + max_new_tokens {max_new_tokens} "
                         f"exceeds max_position_embeddings {max_pos}")
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    dev = next(model.parameters()).device
    buf = torch.zeros(b, total, dtype=torch.int64, device=dev)
    buf[:, :s] = ids.to(dev)
    gen = torch.Generator(device=dev).manual_seed(
        seed if seed is not None else next(_seed_counter))

    cached = use_cache and callable(getattr(model, "init_cache", None)) \
        and not _contains_moe(model)
    loop = _generate_cached if cached else _generate_hostloop
    was_training = model.training
    model.eval()
    try:
        return loop(model, buf, s, total, temperature, top_k, do_sample,
                    eos_token_id, gen)
    finally:
        if was_training:
            model.train()


class GenerationMixin:
    """Adds ``.generate()`` to a causal LM whose ``forward(input_ids)``
    returns logits (and, with ``init_cache``, takes ``caches`` and
    ``cache_pos``)."""

    def generate(self, input_ids, max_new_tokens=20, temperature=1.0,
                 top_k=None, do_sample=False, eos_token_id=None, seed=None,
                 use_cache=True):
        return generate(self, input_ids, max_new_tokens, temperature, top_k,
                        do_sample, eos_token_id, seed, use_cache)
