"""Speculative decoding: prompt-lookup n-gram drafting and exact
verification of K drafted tokens in one forward over the paged KV cache
(counterpart of ``paddle_tpu/serving/speculative.py``).

1. **Draft** (:class:`NgramDrafter`, on the host): up to K continuation
   tokens, found by matching the request's trailing n-gram against its own
   prompt and generated tokens. No second model, no device memory.
2. **Verify** (``ServingModel.verify_forward``): the last accepted token
   and the K drafts of every row run through the model in one forward; the
   drafts' keys and values are written through the page table, and lane
   ``i`` sees the keys at positions ``0 .. base + i``.
3. **Accept** (:func:`verify_tokens`): a greedy row accepts a draft if and
   only if it equals the raw logits' argmax, so the emitted stream is the
   one plain greedy decoding emits. A row with a temperature uses
   rejection sampling against the point-mass draft: draft ``d`` at lane
   ``i`` is accepted with probability ``p_i(d)``; on a rejection the
   replacement is drawn from ``p_i`` with ``d`` taken out, and when every
   draft survives one bonus token is drawn from ``p_K``. Each emitted token
   is then distributed as the target model's. The uniforms and the draws
   come from the engine's ``torch.Generator``, not ``jax.random``.
4. **Roll back** (the scheduler): the row's cursor moves to its accepted
   length and pages that held only rejected drafts are freed.

:class:`SpecState` adapts K per request on an acceptance-rate EWMA, so an
unpredictable stream falls back to plain decode (K = 0) with a one-token
probe every ``probe_every`` steps.
"""

from __future__ import annotations

import torch

__all__ = ["NgramDrafter", "SpecState", "verify_tokens",
           "scaled_filtered_logits"]


def scaled_filtered_logits(logits, temps, top_k=None):
    """Temperature scaling and the top-k filter, in f32: the one logits
    pipeline of the decode sampler (``LLMEngine._sample``) and the verify
    acceptance (:func:`verify_tokens`), so that the two cannot drift.
    ``logits [..., V]``; ``temps`` broadcasts against the leading dims
    (``temps`` for ``[N, V]``, ``temps[:, None]`` for ``[B, S, V]``)."""
    arr = logits.float() / temps.float().clamp_min(1e-6)[..., None]
    if top_k is not None and 1 <= top_k < arr.shape[-1]:
        kth = arr.topk(top_k, dim=-1).values[..., -1:]
        arr = arr.masked_fill(arr < kth, float("-inf"))
    return arr


class NgramDrafter:
    """Prompt-lookup drafter: the longest trailing n-gram of the history,
    matched at its most recent earlier occurrence, proposes the (up to k)
    tokens that followed it. Host-side list work over the last ``window``
    tokens only, so its cost does not grow with the context."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1,
                 window: int = 512):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"min={min_ngram} max={max_ngram}")
        if window <= max_ngram:
            raise ValueError(
                f"window {window} must exceed max_ngram {max_ngram}")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)
        self.window = int(window)

    def propose(self, history, k: int) -> list:
        """The JAX ``propose``'s tokens. Every match of a trailing n-gram
        ends at an earlier occurrence ``p`` of the last token, so only
        those are tried (found by ``list.index``, newest first: a loop the
        generation just entered beats a stale prompt occurrence), longest
        ``n`` first; the continuation after ``p`` is never empty."""
        k = int(k)
        hist = history if isinstance(history, list) else list(history)
        hist = hist[-self.window:]
        size = len(hist)
        n_hi = min(self.max_ngram, size - 1)
        if k <= 0 or n_hi < self.min_ngram:
            return []
        last, ends, p = hist[-1], [], -1
        while True:
            try:
                p = hist.index(last, p + 1, size - 1)
            except ValueError:
                break
            ends.append(p)
        for n in range(n_hi, self.min_ngram - 1, -1):
            suffix = hist[-n:]
            for p in reversed(ends):
                if p >= n - 1 and hist[p - n + 1:p + 1] == suffix:
                    return [int(t) for t in hist[p + 1:p + 1 + k]]
        return []


class SpecState:
    """Per-request adaptive draft length K.

    An acceptance-rate EWMA over verify outcomes: K shrinks by one while it
    sits below ``shrink_below`` (0 is plain decode) and grows back toward
    ``k_max`` while it sits above ``grow_above``. At K = 0 a one-token probe
    is proposed every ``probe_every`` draft opportunities, so a stream that
    turns predictable can climb back. ``adaptive=False`` pins K at
    ``k_max``. Owned by the engine thread."""

    def __init__(self, k_max: int, adaptive: bool = True,
                 shrink_below: float = 0.35, grow_above: float = 0.65,
                 alpha: float = 0.35, probe_every: int = 16):
        self.k_max = int(k_max)
        self.k = int(k_max)
        self.adaptive = bool(adaptive)
        self.shrink_below = float(shrink_below)
        self.grow_above = float(grow_above)
        self.alpha = float(alpha)
        self.probe_every = int(probe_every)
        self.ewma = 0.5          # neutral prior: neither shrink nor grow
        self.idle = 0            # draft opportunities spent at k == 0
        self.proposed_total = 0
        self.accepted_total = 0

    def draft_k(self) -> int:
        """Tokens the drafter may propose this step (0 = skip)."""
        if not self.adaptive:
            return self.k_max
        if self.k == 0:
            self.idle += 1
            if self.idle >= self.probe_every:
                self.idle = 0
                return 1
            return 0
        return self.k

    def update(self, proposed: int, accepted: int) -> None:
        """Fold one verify outcome into the EWMA and move K."""
        if proposed <= 0:
            return
        self.proposed_total += int(proposed)
        self.accepted_total += int(accepted)
        rate = accepted / proposed
        self.ewma = (1.0 - self.alpha) * self.ewma + self.alpha * rate
        if not self.adaptive:
            return
        if self.ewma < self.shrink_below:
            self.k = max(0, self.k - 1)
        elif self.ewma > self.grow_above:
            self.k = min(self.k_max, self.k + 1)

    def acceptance_rate(self):
        if not self.proposed_total:
            return None
        return self.accepted_total / self.proposed_total


def verify_tokens(logits, drafts, draft_len, temps, generator=None,
                  top_k=None):
    """Exact acceptance over one verify forward, on the logits' device.

    logits ``[B, S, V]`` (``S = K + 1``; lane ``i`` is the distribution of
    the token at position ``base + i + 1``), drafts ``[B, K]`` (lane ``i``
    the candidate for position ``base + i + 1``), draft_len ``[B]`` (valid
    drafts a row; 0 is one plain decode step), temps ``[B]`` f32 (0 =
    greedy), ``generator`` the ``torch.Generator`` of the draws (drawn from
    only when a row has a temperature) and ``top_k`` the sampling filter.

    Returns ``(out [B, S] int64, accepted [B] int64)``: row ``b`` emits
    ``out[b, :accepted[b] + 1]``, its accepted drafts and one correction or
    bonus token."""
    b, s, v = logits.shape
    kdr = s - 1
    dev = logits.device
    drafts = drafts.to(device=dev, dtype=torch.long)
    draft_len = draft_len.to(device=dev, dtype=torch.long)
    temps = temps.to(device=dev, dtype=torch.float32)
    lf = logits.float()
    greedy = lf.argmax(-1)                                   # [B, S]
    d_pad = torch.cat([drafts, torch.zeros(b, 1, dtype=torch.long,
                                           device=dev)], dim=1)
    sampling = bool((temps > 0).any())
    accept = drafts == greedy[:, :kdr]
    if sampling:
        p = torch.softmax(scaled_filtered_logits(lf, temps[:, None], top_k),
                          dim=-1)                             # [B, S, V]
        u = torch.rand((b, kdr), generator=generator, device=dev)
        p_draft = p[:, :kdr].gather(-1, drafts[..., None])[..., 0]
        accept = torch.where(temps[:, None] > 0, u < p_draft, accept)
    lane = torch.arange(kdr, device=dev)[None]
    accept = accept & (lane < draft_len[:, None])
    # accepted count: the length of the leading run of accepted lanes
    acc = torch.cumprod(accept.long(), dim=1).sum(dim=1)     # [B]
    corr = greedy.gather(1, acc[:, None])[:, 0]
    if sampling:
        p_a = p.gather(1, acc[:, None, None].expand(b, 1, v))[:, 0]
        d_a = d_pad.gather(1, acc[:, None])[:, 0]
        rejected = acc < draft_len
        vocab = torch.arange(v, device=dev)[None]
        residual = p_a.masked_fill(rejected[:, None]
                                   & (vocab == d_a[:, None]), 0.0)
        # categorical draw from the residual by the Gumbel-max rule
        g = torch.rand((b, v), generator=generator, device=dev)
        g = -torch.log(-torch.log(g.clamp_(min=torch.finfo(torch.float32)
                                            .tiny)))
        sampled = (torch.log(residual) + g).argmax(-1)
        corr = torch.where(temps > 0, sampled, corr)
    lane_s = torch.arange(s, device=dev)[None]
    out = torch.where(lane_s < acc[:, None], d_pad,
                      torch.where(lane_s == acc[:, None], corr[:, None],
                                  torch.zeros_like(d_pad)))
    return out, acc
