"""paddle_tpu_torch serving slice against the JAX serving engine.

A ``llama_tiny`` is built in ``paddle_tpu`` from a seed and its
``state_dict()`` carried across as numpy with ``llama_from_jax_state``.
Then the KV-cache helpers and greedy generation through ``LLMEngine`` are
held against the JAX package on the CPU, in f32: the helpers exactly (or
to 1e-5 where attention sums in another order), greedy tokens exactly;
and the engine's own accounting is checked (slots, eviction, leaks).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import ServingConfig as JaxConfig
from paddle_tpu.serving import kv_cache as jax_kv
from paddle_tpu_torch.models import (Llama, LlamaConfig,
                                     llama_from_jax_state)
from paddle_tpu_torch.serving import (LLMEngine, PageDoubleFree, PagePool,
                                      PagePoolError, PagePoolExhausted,
                                      RequestRejected, ServingConfig,
                                      kv_cache)

# slice 1's path: chunked prefill on the per-op dataflow, no prefix cache
# (the default config is held against JAX in test_torch_default_serving.py)
ENGINE = dict(page_size=8, num_pages=33, max_batch=2, max_new_tokens=6,
              prefill_chunk=8, fused_block=False, prefix_cache=False)
PROMPTS = [[5, 9, 11, 2, 7], [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9]]


@pytest.fixture(scope="module")
def models():
    paddle.seed(11)
    jm = jax_llama_tiny()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    cfg = LlamaConfig(**dataclasses.asdict(jm.cfg))
    return jm, llama_from_jax_state(state, cfg, device="cpu")


def _port_engine(model, **kw):
    return LLMEngine(model, ServingConfig(**{**ENGINE, **kw}), device="cpu")


# -- kv_cache helpers ----------------------------------------------------------

def test_kv_helpers_match_jax():
    rng = np.random.default_rng(0)
    L, P, h_kv, ps, d = 2, 9, 2, 4, 8
    pool = rng.standard_normal((L, P, h_kv, ps, d)).astype(np.float32)
    jpool = jnp.asarray(pool)
    tpool = torch.from_numpy(pool.copy())

    pages = np.asarray([3, 0, 5], np.int32)
    slots = np.asarray([1, 0, 3], np.int32)
    vals = rng.standard_normal((3, h_kv, d)).astype(np.float32)
    jpool = jax_kv.write_token(jpool, 1, jnp.asarray(pages),
                               jnp.asarray(slots), jnp.asarray(vals))
    kv_cache.write_token(tpool, 1, torch.from_numpy(pages),
                         torch.from_numpy(slots), torch.from_numpy(vals))
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))

    row = np.asarray([2, 7, 4, 0], np.int32)
    pvals = rng.standard_normal((12, h_kv, d)).astype(np.float32)
    jpool = jax_kv.write_prefill(jpool, 0, jnp.asarray(row), 10,
                                 jnp.asarray(pvals), ps)
    kv_cache.write_prefill(tpool, 0, torch.from_numpy(row), 10,
                           torch.from_numpy(pvals), ps)
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))

    tables = np.asarray([[2, 7, 4, 0], [5, 0, 0, 0]], np.int32)
    for layer in range(L):
        want = jax_kv.gather_layer(jpool, layer, jnp.asarray(tables))
        got = kv_cache.gather_layer(tpool, layer, torch.from_numpy(tables))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("start", [0, 5, [3, 11]])
def test_chunk_attention_matches_jax(start):
    rng = np.random.default_rng(1)
    b = 2 if isinstance(start, list) else 1
    q = rng.standard_normal((b, 4, 8, 16)).astype(np.float32)
    kc = rng.standard_normal((b, 2, 24, 16)).astype(np.float32)
    vc = rng.standard_normal((b, 2, 24, 16)).astype(np.float32)
    st = np.asarray(start, np.int32)
    want = jax_kv.chunk_attention(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.asarray(st))
    got = kv_cache.chunk_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                   torch.from_numpy(vc),
                                   torch.from_numpy(st))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# -- engine ------------------------------------------------------------------------

def test_greedy_engine_token_exact_vs_jax_engine_and_generate(models):
    jm, tm = models
    jeng = JaxEngine(jm, JaxConfig(**ENGINE))
    teng = _port_engine(tm)
    try:
        for prompt in PROMPTS:
            ref = jm.generate(np.asarray([prompt]), max_new_tokens=6)
            want = [int(t) for t in ref[0, len(prompt):]]
            assert jeng.generate(prompt, timeout=300) == want
            assert teng.generate(prompt, timeout=300) == want
    finally:
        jeng.shutdown()
        assert teng.shutdown()["pages_leaked"] == 0


@pytest.mark.parametrize("path", ["chunked", "default"])
def test_eos_stops_at_the_first_eos_token(models, path):
    """With ``eos_token_id`` set to a token that greedy decoding emits
    mid-stream, each request's output is the plain greedy output cut after
    its first EOS (the EOS kept); a request that never emits it runs to
    ``max_new_tokens``. Both requests run in one batch, on the chunked
    per-op path and on the default ``ServingConfig()`` path."""
    _, tm = models
    kw = dict(max_new_tokens=12)
    if path == "default":
        kw.update(prefill_chunk=None, fused_block=True, prefix_cache=True)
    plain = _port_engine(tm, **kw)
    try:
        want = [plain.generate(p, timeout=300) for p in PROMPTS]
    finally:
        plain.shutdown()
    eos = want[0][len(want[0]) // 2]
    assert eos not in want[0][:len(want[0]) // 2]
    cut = [w[:w.index(eos) + 1] if eos in w else w for w in want]
    assert len(cut[0]) < len(want[0])
    eng = _port_engine(tm, eos_token_id=eos, **kw)
    try:
        reqs = [eng.submit(p) for p in PROMPTS]
        assert [r.result(300) for r in reqs] == cut
    finally:
        assert eng.shutdown()["pages_leaked"] == 0


def test_more_requests_than_slots_with_eviction(models):
    """5 requests on 3 slots and a pool too small for all of them at full
    length: the youngest is evicted and requeued, every request completes
    with the tokens a roomy engine gives, and no page leaks."""
    _, tm = models
    prompts = [[(7 * i + j) % 512 for j in range(6)] for i in range(5)]
    roomy = _port_engine(tm, max_batch=3, page_size=4, num_pages=64,
                         max_new_tokens=10)
    tight = _port_engine(tm, max_batch=3, page_size=4, num_pages=12,
                         max_new_tokens=10)
    try:
        want = [roomy.generate(p, timeout=120) for p in prompts]
        reqs = [tight.submit(p) for p in prompts]
        got = [r.result(timeout=120) for r in reqs]
        assert tight.stats()["evictions"] >= 1
    finally:
        roomy.shutdown()
        summary = tight.shutdown()
    assert got == want
    assert summary["pages_leaked"] == 0 and tight.pool.leaked() == 0
    assert tight.pool.lost() == 0


def test_stream_sampling_and_rejection(models):
    _, tm = models
    eng = _port_engine(tm, temperature=0.8, top_k=20, seed=3)
    try:
        streamed = list(eng.stream(PROMPTS[0]))
        assert len(streamed) == 6 and all(0 <= t < 512 for t in streamed)
        with pytest.raises(RequestRejected):
            eng.submit(list(range(120)), max_new_tokens=20)   # > 128 limit
    finally:
        eng.shutdown()
    again = _port_engine(tm, temperature=0.8, top_k=20, seed=3)
    try:
        assert again.generate(PROMPTS[0]) == streamed    # seeded generator
    finally:
        again.shutdown()


def test_unported_options_raise(models):
    """``spec_k`` and ``prefill_budget`` are ported: each engine serves the
    JAX engine's greedy tokens, and the JAX engine's checks raise the same
    ``ValueError``s."""
    jm, tm = models
    jeng = JaxEngine(jm, JaxConfig(**ENGINE))
    try:
        want = jeng.generate(PROMPTS[1], timeout=300)
    finally:
        jeng.shutdown()
    for kw in (dict(spec_k=2), dict(prefill_budget=8)):
        eng = _port_engine(tm, **kw)
        try:
            assert eng.generate(PROMPTS[1]) == want
        finally:
            assert eng.shutdown()["pages_leaked"] == 0
    for kw in (dict(prefill_budget=0), dict(prefill_chunk=None,
                                           prefill_budget=8),
               dict(spec_k=-1), dict(spec_k=128)):
        with pytest.raises(ValueError):
            _port_engine(tm, **kw)


def test_entry_points_need_cuda_unless_told_cpu(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    jm, tm = models
    with pytest.raises(RuntimeError):
        LLMEngine(tm, ServingConfig(**ENGINE))
    with pytest.raises(RuntimeError):
        Llama(LlamaConfig(**dataclasses.asdict(jm.cfg)))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    with pytest.raises(RuntimeError):
        llama_from_jax_state(state, LlamaConfig(**dataclasses.asdict(jm.cfg)))


# -- page pool ---------------------------------------------------------------------

def test_page_pool_accounting():
    pool = PagePool(1, 9, 1, 8, 4)
    assert pool.allocatable == 8 and pool.free_pages == 8
    pages = pool.alloc(3)
    assert len(pages) == 3 and 0 not in pages       # trash page never leaves
    assert pages == [1, 2, 3]                       # LIFO from the low end
    pool.free(pages[:1])
    with pytest.raises(PageDoubleFree):
        pool.free(pages[:1])
    with pytest.raises(PagePoolError):
        pool.free([pages[1], pages[1]])             # twice in one call
    with pytest.raises(PagePoolError):
        pool.free([0])                              # the trash page
    with pytest.raises(PagePoolExhausted):
        pool.alloc(99)
    assert pool.used_pages == 2                     # failed calls took nothing
    assert pool.alloc(1) == [1]                     # last freed, first reused
    pool.free([1] + pages[1:])
    assert pool.leaked() == 0 and pool.lost() == 0
    assert pool.pages_for(17) == 3 and pool.pages_for(16) == 2
    with pytest.raises(ValueError):
        PagePool(1, 1, 1, 8, 4)
