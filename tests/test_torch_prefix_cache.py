"""paddle_tpu_torch prefix cache: refcounted pages, chain keys, claims,
copy-on-write and the scheduler's accounting, as ``tests/test_prefix_cache.py``
checks them in the JAX package.

Pool and cache cases run on their own; engine cases run a ``llama_tiny``
carried over from the JAX package on the CPU and hold greedy tokens
against JAX ``generate`` (exact); the admission cases drive a
``Scheduler`` over a fake device side for exact page arithmetic.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu.serving import chain_keys as jax_chain_keys
from paddle_tpu.serving import model_fingerprint as jax_fingerprint
from paddle_tpu_torch.models import LlamaConfig, llama_from_jax_state
from paddle_tpu_torch.serving import (LLMEngine, PageDoubleFree, PagePool,
                                      PagePoolError, PagePoolExhausted,
                                      PrefixCache, Request, Scheduler,
                                      ServingConfig, chain_keys,
                                      model_fingerprint)


@pytest.fixture(scope="module")
def models():
    paddle.seed(31)
    jm = jax_llama_tiny()                    # vocab 512, pos 128
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    cfg = LlamaConfig(**dataclasses.asdict(jm.cfg))
    return jm, llama_from_jax_state(state, cfg, device="cpu")


def _engine(model, **kw):
    cfg = dict(page_size=16, num_pages=65, max_batch=2, max_new_tokens=8)
    cfg.update(kw)
    return LLMEngine(model, ServingConfig(**cfg), device="cpu")


def _generate(jm, prompt, n):
    ref = jm.generate(np.asarray([prompt]), max_new_tokens=n)
    return [int(t) for t in ref[0, len(prompt):]]


# -- pool refcounting -----------------------------------------------------------

def test_refcount_share_and_decref_states():
    pool = PagePool(1, 9, 1, 8, 4)
    pages = pool.alloc(2)
    assert all(pool.refcount(p) == 1 for p in pages)
    pool.incref(pages)                       # a second request maps them
    assert pool.shared_pages == 2
    pool.free(pages)                         # first owner leaves
    assert pool.used_pages == 2 and pool.shared_pages == 0
    assert pool.leaked() == 2                # second owner still holds
    pool.free(pages)                         # second owner leaves
    assert pool.used_pages == 0 and pool.leaked() == 0
    assert pool.free_pages == 8 and pool.lost() == 0
    with pytest.raises(PagePoolError):
        pool.incref(pages)                   # free pages cannot be revived


def test_double_free_distinguished_from_foreign_id():
    pool = PagePool(1, 9, 1, 8, 4)
    pages = pool.alloc(1)
    pool.free(pages)
    with pytest.raises(PageDoubleFree):
        pool.free(pages)                     # second decref
    with pytest.raises(PagePoolError) as e:
        pool.free([42])                      # foreign id
    assert not isinstance(e.value, PageDoubleFree)
    assert "never allocated" in str(e.value)
    with pytest.raises(PagePoolError):
        pool.free([3, 3])                    # twice in one call
    # a cached page is also "refcount zero": second decref, not foreign
    p = pool.alloc(1)
    pool.retain_keys([(p[0], b"key")])
    pool.free(p)
    assert pool.cached_pages == 1
    with pytest.raises(PageDoubleFree):
        pool.free(p)
    assert pool.lost() == 0


def test_lru_reclaim_only_takes_refcount_zero_pages():
    evicted = []
    pool = PagePool(1, 9, 1, 8, 4)
    pool.set_reclaim_hook(lambda page, key: evicted.append((page, key)))
    held = pool.alloc(4)
    cached = pool.alloc(4)
    pool.retain_keys([(p, b"k%d" % i) for i, p in enumerate(cached)])
    pool.free(cached)
    assert pool.cached_pages == 4 and pool.free_pages == 0
    assert pool.available_pages == 4
    got = pool.alloc(3)                      # reclaims 3 cached, LRU first
    assert [e[0] for e in evicted] == cached[:3]
    assert set(got) == set(cached[:3])
    with pytest.raises(PagePoolExhausted):
        pool.alloc(2)                        # 1 cached left, 4 held firm
    assert all(pool.refcount(p) == 1 for p in held)
    assert pool.lost() == 0


def test_chain_keys_and_fingerprint_are_the_jax_packages(models):
    jm, tm = models
    toks = list(range(40))
    for fp in (b"fp", b"other"):
        assert chain_keys(fp, toks, 8) == jax_chain_keys(fp, toks, 8)
    for dtype, ps in (("float32", 16), ("bfloat16", 8)):
        assert model_fingerprint(tm, dtype=dtype, page_size=ps) == \
            jax_fingerprint(jm, dtype=dtype, page_size=ps)
    assert model_fingerprint(tm, page_size=8) != \
        model_fingerprint(tm, page_size=16)


def test_claim_prefix_verifies_keys_and_stops_at_mismatch():
    pool = PagePool(1, 9, 1, 8, 4)
    fp = b"fp"
    toks = list(range(24))                   # 3 full pages @ ps=8
    keys = chain_keys(fp, toks, 8)
    assert len(keys) == 3 and keys == chain_keys(fp, toks, 8)
    assert keys != chain_keys(b"other", toks, 8)
    assert keys[1] != chain_keys(fp, toks[:8] + [99] + toks[9:], 8)[1]

    cache = PrefixCache(pool, fp)
    pages = pool.alloc(3)
    assert cache.insert(keys, pages) == 3
    assert cache.insert(keys, pages) == 0    # first writer wins
    pool.free(pages)                         # all three -> cached state
    claimed = cache.claim(keys)
    assert claimed == pages                  # full chain revived
    pool.free(claimed)
    # reclaim page 0's contents out from under the cache: the chain stops
    pool.alloc(pool.free_pages)              # drain the free list
    stolen = pool.alloc(1)                   # forces an LRU reclaim
    assert stolen[0] == pages[0]             # the oldest cached page went
    assert cache.claim(keys) == []           # chain broke at page 0
    assert len(cache) == 2 and pool.lost() == 0


def test_cow_copy_page_moves_contents():
    pool = PagePool(2, 5, 1, 4, 4)
    a, b = pool.alloc(2)
    pool.k[:, a] = 7.0
    pool.v[:, a] = 3.0
    pool.copy_page(a, b)
    assert torch.equal(pool.k[:, b], torch.full_like(pool.k[:, b], 7.0))
    assert torch.equal(pool.v[:, b], torch.full_like(pool.v[:, b], 3.0))


# -- engine: prefix hits, parity, copy-on-write -----------------------------------

@pytest.mark.parametrize("prefill_chunk", [None, 16])
def test_cache_on_token_exact_vs_cache_off_vs_generate(models, prefill_chunk):
    """Greedy tokens with the cache on (the second request hits) equal the
    cache off and JAX ``generate``, on monolithic and chunked prefill."""
    jm, tm = models
    rng = np.random.default_rng(5)
    prompt = [int(t) for t in rng.integers(1, 500, size=40)]  # 2 full pages
    expect = _generate(jm, prompt, 8)
    on = _engine(tm, prefix_cache=True, prefill_chunk=prefill_chunk)
    off = _engine(tm, prefix_cache=False, prefill_chunk=prefill_chunk)
    try:
        miss = on.generate(prompt, timeout=300)
        hit = on.generate(prompt, timeout=300)       # claims cached pages
        plain = off.generate(prompt, timeout=300)
        stats = on.stats()["prefix_cache"]
    finally:
        on.shutdown()
        off.shutdown()
    assert miss == hit == plain == expect
    assert stats["tokens_saved"] == 32 and stats["page_hits"] == 2
    assert on.pool.leaked() == 0 and on.pool.lost() == 0
    assert on.prefix_cache.stats()["hits_total"] == 2


def test_cow_when_live_requests_share_and_diverge(models):
    """Two concurrent requests share prompt pages (refcount 2); the
    full-cover cap puts the second request's last-token write into the
    shared tail page, so it is copied first, and the first request's
    tokens are what they would have been alone."""
    jm, tm = models
    rng = np.random.default_rng(6)
    prompt = [int(t) for t in rng.integers(1, 500, size=32)]  # page-aligned
    expect = _generate(jm, prompt, 16)
    eng = _engine(tm, max_new_tokens=16)
    try:
        r1 = eng.submit(prompt)
        deadline = time.monotonic() + 120
        while len(r1.tokens) < 2 and time.monotonic() < deadline:
            time.sleep(0.005)                # r1 prefilled and decoding
        r2 = eng.submit(prompt)              # claims r1's live pages
        o1, o2 = r1.result(300), r2.result(300)
        stats = eng.scheduler.prefix_stats()
    finally:
        eng.shutdown()
    assert o1 == o2 == expect
    assert stats["cow_copies"] >= 1 and stats["page_hits"] == 2
    assert eng.pool.leaked() == 0 and eng.pool.lost() == 0


def test_eviction_never_frees_shared_pages(models):
    """Evicting a request whose pages are shared drops only its references:
    the other request keeps decoding correct tokens from the pages, and
    the evicted one recovers on re-admission."""
    _, tm = models
    prompt = [1, 2, 3, 4, 5, 6, 7, 8]        # 2 full pages @ ps=4
    solo = _engine(tm, page_size=4, num_pages=33, max_batch=1,
                   max_new_tokens=18, prefix_cache=False)
    eng = _engine(tm, page_size=4, num_pages=11, max_batch=2,
                  max_new_tokens=18)
    try:
        expect = solo.generate(prompt, timeout=300)
        a, b = eng.submit(prompt), eng.submit(prompt)
        ra, rb = a.result(300), b.result(300)
    finally:
        solo.shutdown()
        eng.shutdown()
    assert ra == rb == expect
    assert eng.scheduler.evictions >= 1
    assert eng.pool.leaked() == 0 and eng.pool.lost() == 0


# -- admission accounting over a fake device side ---------------------------------

class _FakePrograms:
    def prefill(self, req):
        return 7

    def bucket_for(self, n):
        return 8

    def prefill_chunk(self, req, n):
        return 7

    def decode(self, tokens, positions, tables, temps):
        return np.full(tokens.shape, 7, np.int32)


def _fake_sched(num_pages, max_batch=2, max_seq_len=32, page_size=4):
    pool = PagePool(num_layers=1, num_pages=num_pages, num_kv_heads=1,
                    page_size=page_size, head_dim=2)
    return Scheduler(pool, _FakePrograms(), max_batch=max_batch,
                     max_seq_len=max_seq_len,
                     prefix_cache=PrefixCache(pool, b"fake-fingerprint"))


def test_blocked_admission_does_not_inflate_hit_counters():
    """The head-of-line request retries its claim every iteration while
    blocked on pages: hits and misses count once, at admission."""
    sched = _fake_sched(num_pages=7)         # 6 allocatable @ ps=4
    pool, cache = sched.pool, sched.prefix_cache
    prompt = list(range(40, 60))             # 5 pages; first 2 cached
    keys = cache.keys_for(prompt)
    seeded = pool.alloc(2)
    cache.insert(keys[:2], seeded)
    pool.free(seeded)                        # -> cached state, claimable
    hog = pool.alloc(4)                      # free 0 + cached 2 available
    sched.submit(Request(prompt, max_new_tokens=2))
    for _ in range(5):                       # blocked: need 4 > available 2
        sched._admit()
    assert len(sched.waiting) == 1
    assert sched.prefix_page_hits == 0 and sched.prefix_page_misses == 0
    assert cache.hits_total == 0 and pool.cached_pages == 2
    pool.free(hog)                           # headroom appears
    sched._admit()
    assert not sched.waiting
    assert sched.prefix_page_hits == 2 and sched.prefix_page_misses == 3
    assert cache.hits_total == 2 and cache.misses_total == 3


def test_admission_headroom_counts_full_cover_cow_page():
    """A full-cover claim whose capped last-token write lands in a shared
    page needs one more page for the copy: admission waits for it instead
    of admitting into an eviction."""
    sched = _fake_sched(num_pages=9)         # 8 allocatable @ ps=4
    pool = sched.pool
    prompt = list(range(70, 78))             # 2 pages, page-aligned
    r1 = sched.submit(Request(prompt, max_new_tokens=4))
    sched._admit()                           # r1 live, its pages keyed
    assert r1.slot is not None and pool.used_pages == 2
    hog = pool.alloc(5)                      # available_pages == 1
    r2 = sched.submit(Request(prompt, max_new_tokens=4))
    for _ in range(3):
        # full cover: need = pages_for(9) - 2 + 1 copy = 2 > 1
        sched._admit()
    assert r2.slot is None and len(sched.waiting) == 1
    assert sched.evictions == 0
    pool.free(hog[:1])                       # available_pages == 2
    sched._admit()
    assert r2.slot is not None and not sched.waiting
    assert sched.cow_copies == 1             # the shared tail was copied
    assert r2.prefilled == 8 and r2._cached_tokens == 7
    assert pool.lost() == 0 and sched.evictions == 0
