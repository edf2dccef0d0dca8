"""paddle_tpu_torch speculative decoding and the prefill budget.

The drafter, the adaptive K and the greedy acceptance are held against the
JAX functions on the same numpy inputs, exactly; ``verify_forward``'s
logits against the JAX ``ServingModel.verify_forward`` on a ``llama_tiny``
carried across with ``llama_from_jax_state`` (its Pallas kernels in
interpret mode), in f32 to 1e-4, on both ``fused_block`` settings. The
engine's behaviours run on the port alone, on a one-layer model: greedy
spec-on equals spec-off equals ``generate``, token for token, with drafts
that land by construction (a drafter that replays the spec-off output), the
rollback and copy-on-write cases, adaptive K and the composition with int8
and the prefix cache. The temperature acceptance is a chi-squared test.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu.ops.kernels import _common as jax_kern
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import NgramDrafter as JaxDrafter
from paddle_tpu.serving import ServingConfig as JaxConfig
from paddle_tpu.serving import SpecState as JaxSpecState
from paddle_tpu.serving import kv_cache as jax_kv
from paddle_tpu.serving import verify_tokens as jax_verify_tokens
from paddle_tpu.serving.model import ServingModel as JaxServingModel
from paddle_tpu_torch.models import (LlamaConfig, llama_from_jax_state,
                                     llama_tiny)
from paddle_tpu_torch.serving import (LLMEngine, NgramDrafter, PagePool,
                                      ServingConfig, ServingModel, SpecState,
                                      verify_tokens)
from paddle_tpu_torch.serving.scheduler import Request, Scheduler

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    paddle.seed(11)
    jm = jax_llama_tiny()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    cfg = LlamaConfig(**dataclasses.asdict(jm.cfg))
    return jm, llama_from_jax_state(state, cfg, device="cpu")


@pytest.fixture(scope="module")
def small():
    """A one-layer port model (the JAX speculative tests' ``_model``)."""
    return llama_tiny(device="cpu", seed=5, vocab_size=128,
                      max_position_embeddings=64, hidden_size=32,
                      num_layers=1, num_heads=2, num_kv_heads=1,
                      intermediate_size=64)


def _engine(model, **kw):
    cfg = dict(page_size=8, num_pages=17, max_batch=2, max_new_tokens=6)
    cfg.update(kw)
    return LLMEngine(model, ServingConfig(**cfg), device="cpu")


class _Replay:
    """Proposes the spec-off continuation of ``prompt``: every draft lands
    while the outputs agree. No ``window``, so it gets the whole context."""

    def __init__(self, prompt, ref, shift=0, vocab=128):
        self.prompt, self.ref, self.shift, self.vocab = prompt, ref, shift, \
            vocab

    def propose(self, history, k):
        done = len(history) - len(self.prompt)
        return [(t + self.shift) % self.vocab
                for t in self.ref[done:done + k]]


def _wrong(prompt, ref, vocab=128):
    """Drafts that are never the argmax while the outputs agree."""
    return _Replay(prompt, ref, shift=1, vocab=vocab)


# -- functions against JAX -----------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(max_ngram=2), dict(min_ngram=2),
                                dict(window=8)])
def test_ngram_drafter_matches_jax(kw):
    rng = np.random.default_rng(len(kw) + 7 * len(str(kw)))
    jd, td = JaxDrafter(**kw), NgramDrafter(**kw)
    assert (td.max_ngram, td.min_ngram, td.window) == \
        (jd.max_ngram, jd.min_ngram, jd.window)
    for i in range(260):
        if i < 200:     # short histories over a few tokens: many matches
            vocab = int(rng.integers(2, 9))
            hist = rng.integers(0, vocab,
                                size=int(rng.integers(0, 40))).tolist()
        else:           # long ones over a wide vocabulary, with a loop
            hist = rng.integers(0, 5000,
                                size=int(rng.integers(1, 700))).tolist()
            at = int(rng.integers(0, len(hist)))
            hist += hist[at:at + int(rng.integers(1, 12))]
        k = int(rng.integers(0, 6))
        assert td.propose(hist, k) == jd.propose(hist, k), (hist, k)
        assert td.propose(tuple(hist), k) == jd.propose(tuple(hist), k)


def test_ngram_drafter_checks_match_jax():
    for kw in (dict(max_ngram=1, min_ngram=2), dict(max_ngram=3, window=3),
               dict(min_ngram=0)):
        with pytest.raises(ValueError) as want:
            JaxDrafter(**kw)
        with pytest.raises(ValueError) as got:
            NgramDrafter(**kw)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("adaptive", [True, False])
def test_spec_state_trajectory_matches_jax(adaptive):
    rng = np.random.default_rng(3)
    js, ts = JaxSpecState(4, adaptive), SpecState(4, adaptive)
    for step in range(300):
        phase = (step // 60) % 2        # bad and good streams in turns
        k = ts.draft_k()
        assert k == js.draft_k()
        if k:
            acc = int(rng.integers(0, k + 1)) if phase else \
                int(rng.random() < 0.1)
            ts.update(k, acc)
            js.update(k, acc)
        assert (ts.k, ts.idle, ts.proposed_total, ts.accepted_total) == \
            (js.k, js.idle, js.proposed_total, js.accepted_total)
        assert ts.ewma == js.ewma
    assert ts.acceptance_rate() == js.acceptance_rate()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_verify_tokens_greedy_matches_jax(seed):
    rng = np.random.default_rng(seed)
    b, s, v = 6, 5, 11
    logits = rng.standard_normal((b, s, v)).astype(np.float32)
    greedy = logits.argmax(-1)
    drafts = greedy[:, :s - 1].copy()
    # break some drafts at a seeded lane (some rows keep all)
    for r in range(b):
        lane = int(rng.integers(0, s + 1))
        if lane < s - 1:
            drafts[r, lane] = (drafts[r, lane] + 1) % v
    dlen = rng.integers(0, s, size=b).astype(np.int32)
    jout, jacc = jax_verify_tokens(
        jnp.asarray(logits), jnp.asarray(drafts.astype(np.int32)),
        jnp.asarray(dlen), jnp.zeros(b, jnp.float32), jax.random.PRNGKey(0),
        jnp.uint32(0))
    tout, tacc = verify_tokens(torch.from_numpy(logits),
                               torch.from_numpy(drafts),
                               torch.from_numpy(dlen), torch.zeros(b))
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


def test_temperature_acceptance_distribution_chisq():
    """The emitted token's marginal under rejection sampling against a
    point-mass draft equals the target softmax: the acceptance count is
    Binomial(n, p(draft)), and chi-squared against the analytic
    distribution and against direct sampling (df 5, far past alpha
    1e-3)."""
    rng = np.random.default_rng(0)
    n, v, draft = 4000, 6, 2
    lg = rng.standard_normal((1, 2, v)).astype(np.float32)
    p = np.exp(lg[0, 0]) / np.exp(lg[0, 0]).sum()
    gen = torch.Generator().manual_seed(7)
    out, acc = verify_tokens(torch.from_numpy(np.repeat(lg, n, axis=0)),
                             torch.full((n, 1), draft), torch.ones(n),
                             torch.ones(n), gen)
    emitted = out[:, 0].numpy()
    acc_n = int(acc.sum())
    assert 0 < acc_n < n
    assert abs(acc_n / n - p[draft]) < 4 * np.sqrt(p[draft] / n)
    counts = np.bincount(emitted, minlength=v)
    assert ((counts - p * n) ** 2 / (p * n)).sum() < 25, counts
    direct = torch.multinomial(torch.from_numpy(p).float(), n,
                               replacement=True,
                               generator=torch.Generator().manual_seed(11))
    d_counts = np.bincount(direct.numpy(), minlength=v)
    pooled = (counts + d_counts) / (2 * n)
    chi2 = (((counts - pooled * n) ** 2 / (pooled * n)).sum()
            + ((d_counts - pooled * n) ** 2 / (pooled * n)).sum())
    assert chi2 < 25, (counts, d_counts)


@pytest.mark.parametrize("fused_block", [True, False])
def test_verify_forward_matches_jax(models, fused_block):
    """Three rows of K + 1 = 4 lanes (draft lengths 3, 0 and 2) over a pool
    filled from one seed: the logits of every valid lane and the pool after
    the draft writes, against the JAX verify (f32 ``chunk_attention``; here
    mmha's plain version over the lanes)."""
    jm, tm = models
    cfg = jm.cfg
    shape = (cfg.num_layers, 17, cfg.num_kv_heads, 8, cfg.head_dim)
    jpool, tpool = jax_kv.PagePool(*shape), PagePool(*shape)
    rng = np.random.default_rng(4)
    for name in ("k", "v"):
        fill = rng.standard_normal(shape).astype(np.float32)
        getattr(jpool, name)._data = jnp.asarray(fill)
        getattr(tpool, name).copy_(torch.from_numpy(fill))
    jax_kern.force_interpret(True)
    try:
        jsm = JaxServingModel(jm, fused_block=fused_block).bind_pool(jpool)
        tsm = ServingModel(tm, fused_block=fused_block).bind_pool(tpool)
        tables = np.zeros((3, 16), np.int32)
        tables[0, :3] = [4, 9, 13]
        tables[1, :2] = [2, 11]
        tables[2, :2] = [5, 1]
        toks = rng.integers(0, cfg.vocab_size, size=(3, 4)).astype(np.int32)
        positions = np.asarray([17, 9, 13], np.int32)
        dlen = np.asarray([3, 0, 2], np.int32)
        want = np.asarray(jsm.verify_forward(
            paddle.to_tensor(toks), paddle.to_tensor(positions),
            paddle.to_tensor(dlen), paddle.to_tensor(tables)).numpy())
        got = tsm.verify_forward(
            torch.from_numpy(toks), torch.from_numpy(positions),
            torch.from_numpy(dlen), torch.from_numpy(tables)).numpy()
    finally:
        jax_kern.force_interpret(False)
    assert got.shape == want.shape == (3, 4, cfg.vocab_size)
    for r in range(3):
        np.testing.assert_allclose(got[r, :dlen[r] + 1],
                                   want[r, :dlen[r] + 1], **LOGIT_TOL)
    # every page but the trash page holds the same keys and values
    for name in ("k", "v"):
        np.testing.assert_allclose(
            getattr(tpool, name).numpy()[:, 1:],
            np.asarray(getattr(jpool, name)._data)[:, 1:], **LOGIT_TOL)


# -- the engine: exactness ------------------------------------------------------

@pytest.mark.parametrize("drafter", ["ngram", "replay"])
def test_greedy_spec_on_off_generate_token_exact(small, drafter):
    """Greedy spec-on == spec-off == ``model.generate``; the replay drafter
    lands drafts by construction, so speculation really emits bursts."""
    prompt = [5, 9, 11, 2, 7, 5, 9]
    ref = small.generate(torch.tensor([prompt]), max_new_tokens=24)
    expect = ref[0, len(prompt):].tolist()
    off = _engine(small, page_size=16, num_pages=9, max_new_tokens=24)
    on = _engine(small, page_size=16, num_pages=9, max_new_tokens=24,
                 spec_k=4)
    if drafter == "replay":
        on.scheduler.drafter = _Replay(prompt, expect)
    try:
        assert off.generate(prompt, timeout=300) == expect
        assert on.generate(prompt, timeout=300) == expect
        stats = on.stats()
    finally:
        off.shutdown()
        on.shutdown()
    spec = stats["speculative"]
    assert spec["enabled"] and spec["proposed_tokens"] == \
        spec["accepted_tokens"] + spec["rejected_tokens"]
    if drafter == "replay":
        assert spec["accepted_tokens"] >= 1
        assert stats["tokens_per_step"] > 1.0
        assert len(on.verify_ms) == spec["verify_steps"] >= 1
    assert on.pool.leaked() == 0 and on.pool.lost() == 0


def test_spec_emission_respects_eos_mid_burst(small):
    prompt = [3, 1, 3, 1]
    probe = _engine(small, max_new_tokens=12)
    ref = probe.generate(prompt, timeout=300)
    probe.shutdown()
    eos = ref[len(ref) // 2]
    want = ref[:ref.index(eos) + 1]
    on = _engine(small, max_new_tokens=12, eos_token_id=eos, spec_k=4)
    on.scheduler.drafter = _Replay(prompt, ref)
    try:
        got = on.generate(prompt, timeout=300)
        spec = on.scheduler.spec_stats()
    finally:
        on.shutdown()
    assert got == want                     # the burst stops at the eos
    assert spec["accepted_tokens"] >= 1
    assert on.pool.leaked() == 0 and on.pool.lost() == 0


def test_int8_prefix_cache_and_speculation_compose_token_exact(small):
    prompt = [3, 1, 4] * 5 + [3]
    kw = dict(quant="weight_only_int8", page_size=8, num_pages=33,
              max_new_tokens=24, prefix_cache=True)
    off = _engine(small, **kw)
    on = _engine(small, spec_k=3, **kw)
    try:
        miss_off = off.generate(prompt, timeout=300)
        hit_off = off.generate(prompt, timeout=300)
        miss_on = on.generate(prompt, timeout=300)
        hit_on = on.generate(prompt, timeout=300)
        pstats = on.scheduler.prefix_stats()
        spec = on.scheduler.spec_stats()
    finally:
        off.shutdown()
        on.shutdown()
    assert miss_off == hit_off == miss_on == hit_on
    assert pstats["page_hits"] >= 1 and spec["proposed_tokens"] >= 1
    assert on._sm.quantized
    assert on.pool.leaked() == 0 and on.pool.lost() == 0


# -- rollback and copy-on-write -------------------------------------------------

def test_rollback_frees_rejected_draft_pages_and_stays_exact(small):
    """All drafts rejected: one token a verify step, no page held past the
    accepted length between steps, the spec-off stream; with the pool
    hogged a draft span yields instead of evicting, and the request
    decodes plainly."""
    prompt = [9, 8, 7]
    probe = _engine(small, page_size=4, num_pages=33, max_new_tokens=10)
    ref = probe.generate(prompt, timeout=300)
    probe.shutdown()
    eng = _engine(small, page_size=4, num_pages=33, max_new_tokens=10,
                  spec_k=3)
    sched = eng.scheduler
    sched.drafter = _wrong(prompt, ref)
    req = Request(prompt, max_new_tokens=10)
    free0 = eng.pool.free_pages
    try:
        sched.submit(req)            # stepped by hand: no engine thread
        for _ in range(64):
            if req.finished:
                break
            sched.step()
            if req.slot is not None:
                assert len(req.pages) <= eng.pool.pages_for(req.cur_len())
        assert req.state == "completed" and req.tokens == ref
        assert sched.spec_rejected >= 1 and sched.spec_accepted == 0
        req2 = Request(prompt, max_new_tokens=10)
        sched.submit(req2)
        sched._admit()
        assert req2.slot is not None
        hog = eng.pool.alloc(eng.pool.free_pages)
        assert not sched._ensure_spec_pages(req2, 3)
        assert req2.slot is not None and sched.evictions == 0
        eng.pool.free(hog)
        while not req2.finished:
            sched.step()
        assert req2.tokens == ref
    finally:
        eng.shutdown(drain=False)
    assert eng.pool.free_pages == free0
    assert eng.pool.leaked() == 0 and eng.pool.lost() == 0


def test_rollback_under_cow_leaves_other_owners_kv_untouched(small):
    """A shared page in the draft span is copied before the draft writes:
    the original's bytes stay as they were for its other owner."""
    prompt = [6, 5, 4]
    probe = _engine(small, page_size=4, num_pages=33, max_new_tokens=8)
    ref = probe.generate(prompt, timeout=300)
    probe.shutdown()
    eng = _engine(small, page_size=4, num_pages=33, max_new_tokens=8,
                  spec_k=3)
    sched = eng.scheduler
    sched.drafter = _wrong(prompt, ref)
    req = Request(prompt, max_new_tokens=8)
    try:
        sched.submit(req)
        sched.step()                          # prefill and a first step
        assert req.slot is not None and req.tokens
        idx = (req.cur_len() - 1) // eng.pool.page_size
        shared = req.pages[idx]
        eng.pool.incref([shared])             # a second owner of the page
        snap = (eng.pool.k[:, shared].clone(), eng.pool.v[:, shared].clone())
        cow0 = sched.cow_copies
        sched.step()                          # verify: copy, then reject
        assert sched.cow_copies >= cow0 + 1 and sched.spec_rejected >= 1
        assert torch.equal(eng.pool.k[:, shared], snap[0])
        assert torch.equal(eng.pool.v[:, shared], snap[1])
        assert shared not in req.pages
        while not req.finished:
            sched.step()
        assert req.tokens == ref
        eng.pool.free([shared])
    finally:
        eng.shutdown(drain=False)
    assert eng.pool.leaked() == 0 and eng.pool.lost() == 0


def test_speculation_never_evicts_other_requests_for_draft_pages(small):
    eng = _engine(small, page_size=4, num_pages=9, max_new_tokens=8,
                  spec_k=3)
    try:
        a = eng.submit([1, 2, 1, 2, 1])
        b = eng.submit([3, 4, 3, 4, 3])
        ra, rb = a.result(300), b.result(300)
    finally:
        eng.shutdown()
    assert len(ra) == 8 and len(rb) == 8
    assert eng.scheduler.evictions == 0
    assert eng.pool.leaked() == 0 and eng.pool.lost() == 0


class _OnlyFor:
    """Drafts k wrong tokens for histories starting with ``first``."""

    def __init__(self, first):
        self.first = first

    def propose(self, history, k):
        if not history or history[0] != self.first or k <= 0:
            return []
        return [(history[-1] + 1) % 128] * k


def test_spec_growth_yields_last_page_to_plain_decode(small):
    """Every row's plain-decode page comes before any draft span: with one
    free page, the non-drafting row B takes it for its first decode write
    and A's span yields (page_size 4, 5 allocatable pages)."""
    eng = _engine(small, page_size=4, num_pages=6, max_new_tokens=4,
                  spec_k=3, prefix_cache=False)
    eng.scheduler.drafter = _OnlyFor(9)
    try:
        a = eng.submit([9, 2, 3, 4, 5, 6, 7])
        b = eng.submit([3, 2, 3, 4, 5, 6, 7, 8], max_new_tokens=2)
        ra, rb = a.result(300), b.result(300)
        spec = eng.scheduler.spec_stats()
        evictions = eng.scheduler.evictions
    finally:
        eng.shutdown()
    assert len(ra) == 4 and len(rb) == 2 and evictions == 0
    assert spec["proposed_tokens"] > 0 and spec["accepted_tokens"] == 0
    assert eng.pool.leaked() == 0 and eng.pool.lost() == 0


def test_adaptive_k_shrinks_to_zero_on_adversarial_stream(small):
    prompt = [2, 4, 6]
    probe = _engine(small, page_size=8, num_pages=17, max_new_tokens=40)
    ref = probe.generate(prompt, timeout=300)
    probe.shutdown()
    eng = _engine(small, page_size=8, num_pages=17, max_new_tokens=40,
                  spec_k=4)
    eng.scheduler.drafter = _wrong(prompt, ref)
    try:
        req = eng.submit(prompt)
        got = req.result(timeout=300)
        spec = eng.scheduler.spec_stats()
        steps = eng.scheduler.decode_steps
    finally:
        eng.shutdown()
    assert got == ref and req.spec.k == 0
    assert spec["accepted_tokens"] == 0 and spec["verify_steps"] <= 10
    assert steps >= 35                 # one token a step, as plain decode
    assert eng.pool.leaked() == 0 and eng.pool.lost() == 0


# -- the prefill budget --------------------------------------------------------

class _Chunks:
    """A stand-in for the engine's device side that records the prefill
    chunk sizes of every iteration."""

    def __init__(self):
        self.iterations = [[]]

    def prefill_chunk(self, req, n):
        self.iterations[-1].append(n)
        req.prefilled += n
        return 1 if req.prefilled >= len(req.context()) else None

    def decode(self, tokens, positions, tables, temps):
        return np.ones(len(tokens), np.int32)

    def bucket_for(self, n):
        return n


def _chunk_iterations(scheduler_cls, request_cls, pool, budget):
    progs = _Chunks()
    sched = scheduler_cls(pool, progs, max_batch=2, max_seq_len=32,
                          prefill_chunk=4, prefill_budget=budget)
    for p in (list(range(1, 11)), list(range(11, 21))):
        sched.submit(request_cls(p, max_new_tokens=1))
    while sched.has_work():
        sched.step()
        progs.iterations.append([])
    assert pool.leaked() == 0
    return [it for it in progs.iterations if it]


@pytest.mark.parametrize("budget,want", [
    (None, [[4], [4], [2, 2], [4], [4]]),
    (6, [[4, 2], [4, 2], [2, 4], [2]]),
    (20, [[4, 4], [4, 4], [2, 2]])])
def test_prefill_budget_caps_chunk_tokens_per_iteration(budget, want):
    """Chunks of 4 over two 10-token prompts: an iteration spends at most
    ``prefill_budget`` tokens (default: one chunk), a chunk a request,
    oldest first; the JAX scheduler spends them the same way."""
    from paddle_tpu.serving.scheduler import Request as JaxRequest
    from paddle_tpu.serving.scheduler import Scheduler as JaxScheduler
    assert _chunk_iterations(Scheduler, Request, PagePool(1, 17, 1, 4, 4),
                             budget) == want
    assert _chunk_iterations(JaxScheduler, JaxRequest,
                             jax_kv.PagePool(1, 17, 1, 4, 4), budget) == want


@pytest.mark.parametrize("kw", [dict(prefill_budget=0, prefill_chunk=8),
                                dict(prefill_budget=8),
                                dict(spec_k=-1), dict(spec_k=128)])
def test_constructor_checks_match_jax(models, kw):
    jm, tm = models
    with pytest.raises(ValueError) as want:
        JaxEngine(jm, JaxConfig(**kw))
    with pytest.raises(ValueError) as got:
        LLMEngine(tm, ServingConfig(**kw), device="cpu")
    assert str(got.value) == str(want.value)
