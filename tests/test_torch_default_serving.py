"""paddle_tpu_torch on the JAX engine's default serving path.

A ``llama_tiny`` is built in ``paddle_tpu`` from a seed and its
``state_dict()`` carried across as numpy with ``llama_from_jax_state``.
The JAX side runs its Pallas kernels in interpret mode, so its fused trunk
(flash attention and the block epilogues) is what the port is held
against. On the CPU in f32: ``Llama.forward`` and the fused-block serving
forwards (monolithic prefill, chunk, decode) to 1e-4, the same math summed
in another order through a few layers; greedy tokens of the default
``ServingConfig()`` exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu.ops.kernels import _common as jax_kern
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import ServingConfig as JaxConfig
from paddle_tpu.serving import kv_cache as jax_kv
from paddle_tpu.serving.model import ServingModel as JaxServingModel
from paddle_tpu_torch.models import LlamaConfig, llama_from_jax_state
from paddle_tpu_torch.ops.kernels import WRAPPERS
from paddle_tpu_torch.serving import (LLMEngine, PagePool, ServingConfig,
                                      ServingModel)

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9]


@pytest.fixture(scope="module")
def models():
    paddle.seed(11)
    jm = jax_llama_tiny()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    cfg = LlamaConfig(**dataclasses.asdict(jm.cfg))
    return jm, llama_from_jax_state(state, cfg, device="cpu")


@pytest.fixture
def interpret():
    jax_kern.force_interpret(True)
    try:
        yield
    finally:
        jax_kern.force_interpret(False)


def test_default_config_equals_jax_default():
    port, ref = ServingConfig(), JaxConfig()
    for name in ("prefill_chunk", "fused_block", "prefix_cache", "page_size",
                 "num_pages", "max_batch", "max_new_tokens", "temperature",
                 "dtype", "spec_k", "quant", "fused_decode_layer",
                 "prefill_budget", "spec_adaptive"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.prefill_chunk is None and port.fused_block \
        and port.prefix_cache


def test_llama_forward_matches_jax_fused_trunk(models, interpret):
    jm, tm = models
    ids = np.asarray([PROMPT, PROMPT[::-1]], np.int64)
    assert jm._use_fused_blocks()
    want = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    for w in WRAPPERS.values():
        w.launches = 0
    with torch.no_grad():              # the forward tracks grads otherwise
        got = tm(torch.from_numpy(ids))
        got_plain = tm(torch.from_numpy(ids), plain=True)
    assert all(w.launches == 0 for w in WRAPPERS.values())   # CPU: plain
    assert got.shape == (2, len(PROMPT), tm.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    np.testing.assert_allclose(got_plain.numpy(), want, **LOGIT_TOL)


def test_fused_serving_forwards_match_jax(models, interpret):
    """Monolithic prefill of one request (at the JAX bucket's padded
    length and at the prompt's own), a chunked prefill of another, then
    one fused decode step over both and an inactive slot."""
    jm, tm = models
    cfg = jm.cfg
    shape = (cfg.num_layers, 17, cfg.num_kv_heads, 8, cfg.head_dim)
    jsm = JaxServingModel(jm, fused_block=True).bind_pool(
        jax_kv.PagePool(*shape))
    assert jsm._fused_active()
    tsm = ServingModel(tm).bind_pool(PagePool(*shape))
    assert tsm.fused_block
    tables = np.zeros((3, 16), np.int32)
    tables[0, :2] = [4, 9]
    tables[2, :2] = [2, 11]
    nxt = np.zeros(3, np.int32)

    toks = np.zeros((1, 16), np.int32)                 # JAX's bucket of 16
    toks[0, :len(PROMPT)] = PROMPT
    want = np.asarray(jsm.prefill_forward(
        paddle.to_tensor(toks), paddle.to_tensor(np.int32(len(PROMPT))),
        paddle.to_tensor(tables[0])).numpy())
    for t in (toks, toks[:, :len(PROMPT)]):            # padded, own length
        got = tsm.prefill_forward(torch.from_numpy(t), len(PROMPT),
                                  torch.from_numpy(tables[0]))
        np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    nxt[0] = int(want.argmax())

    prompt = PROMPT[::-1]
    for start, n in ((0, 8), (8, 5)):
        toks = np.zeros((1, 8), np.int32)
        toks[0, :n] = prompt[start:start + n]
        want = np.asarray(jsm.prefill_chunk_forward(
            paddle.to_tensor(toks), paddle.to_tensor(np.int32(start)),
            paddle.to_tensor(np.int32(n)),
            paddle.to_tensor(tables[2])).numpy())
        got = tsm.prefill_chunk_forward(torch.from_numpy(toks), start, n,
                                        torch.from_numpy(tables[2]))
        np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    nxt[2] = int(want.argmax())

    positions = np.asarray([13, 0, 13], np.int32)
    want = np.asarray(jsm.decode_forward(
        paddle.to_tensor(nxt), paddle.to_tensor(positions),
        paddle.to_tensor(tables)).numpy())
    got = tsm.decode_forward(torch.from_numpy(nxt),
                             torch.from_numpy(positions),
                             torch.from_numpy(tables)).numpy()
    assert np.isfinite(got).all()
    for r in (0, 2):
        np.testing.assert_allclose(got[r], want[r], **LOGIT_TOL)
    plain = tsm.decode_forward(torch.from_numpy(nxt),
                               torch.from_numpy(positions),
                               torch.from_numpy(tables), plain=True)
    np.testing.assert_array_equal(plain.numpy()[[0, 2]], got[[0, 2]])


def test_default_engine_greedy_tokens_equal_generate_and_jax_engine(models):
    """The port's ``ServingConfig()`` (monolithic prefill, fused blocks,
    prefix cache) against ``jm.generate`` and the JAX default engine; the
    second round of the same prompts hits the prefix cache."""
    jm, tm = models
    engine_kw = dict(page_size=8, num_pages=33, max_batch=2,
                     max_new_tokens=6)
    prompts = [PROMPT, [5, 9, 11, 2, 7], PROMPT[:8] + [1, 2]]
    want = []
    for p in prompts:
        ref = jm.generate(np.asarray([p]), max_new_tokens=6)
        want.append([int(t) for t in ref[0, len(p):]])
    jeng = JaxEngine(jm, JaxConfig(**engine_kw))
    teng = LLMEngine(tm, ServingConfig(**engine_kw), device="cpu")
    try:
        assert [jeng.generate(p, timeout=300) for p in prompts] == want
        for _ in range(2):
            assert [teng.generate(p, timeout=300) for p in prompts] == want
        stats = teng.stats()
    finally:
        jeng.shutdown()
        summary = teng.shutdown()
    assert summary["pages_leaked"] == 0 and teng.pool.lost() == 0
    px = stats["prefix_cache"]
    # one full page each: PROMPT's (missed once, then hit) is also the
    # first page of the third prompt (hit in both rounds)
    assert px["enabled"] and px["page_hits"] == 3 \
        and px["tokens_saved"] == 3 * 8
    assert len(teng.prefill_ms) == 6 and not teng.chunk_ms
