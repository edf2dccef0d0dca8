"""Text generation (counterpart of ``paddle_tpu/models/generation.py``):
the exact-length host loop that decodes a model holding a ``MoELayer``.

Capacity routing is not causal: padding tokens would compete for expert
capacity and could evict real tokens of other rows, so a MoE model decodes
with the exact prefix at every step (``generation.py:255-287``, chosen at
:321): one whole forward per emitted token, the next token from the last
position's logits. Greedy decoding takes their argmax. Sampling divides by
``temperature``, keeps the ``top_k`` largest logits and takes the
Gumbel-max draw, from a ``torch.Generator`` seeded with ``seed``; an
unseeded call takes the next value of a process counter, as JAX's
``_seed_counter`` does (:30), never wall-clock entropy. The bits are not
``jax.random``'s.

Dense decoding (JAX's ``_decode_fn`` loop and the ``init_cache`` cached
decode) is not ported: a model without a ``MoELayer`` raises.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

__all__ = ["GenerationMixin", "generate"]

_seed_counter = itertools.count(1)


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


def _generate_moe_hostloop(model, buf, s, total, temperature, top_k,
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


def generate(model, input_ids, max_new_tokens=20, temperature=1.0,
             top_k=None, do_sample=False, eos_token_id=None, seed=None):
    """``input_ids``: a ``[B, S]`` prompt (tensor, array or nested list).
    Returns an int64 ``[B, S + max_new_tokens]`` tensor on the model's
    device; a row that emits ``eos_token_id`` emits it for the rest of the
    buffer, and once every row has, the tail is ``eos_token_id``."""
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

    was_training = model.training
    model.eval()
    try:
        if not _contains_moe(model):
            raise NotImplementedError(
                "generate: the port decodes only models that hold a "
                "MoELayer (the exact-length host loop); dense decoding "
                "(JAX's _decode_fn loop and the init_cache cached decode) "
                "is not ported yet (ROADMAP Queue 1, the serving and "
                "generation surface)")
        return _generate_moe_hostloop(model, buf, s, total, temperature,
                                      top_k, do_sample, eos_token_id, gen)
    finally:
        if was_training:
            model.train()


class GenerationMixin:
    """Adds ``.generate()`` to a causal LM whose ``forward(input_ids)``
    returns logits."""

    def generate(self, input_ids, max_new_tokens=20, temperature=1.0,
                 top_k=None, do_sample=False, eos_token_id=None, seed=None):
        return generate(self, input_ids, max_new_tokens, temperature, top_k,
                        do_sample, eos_token_id, seed)
