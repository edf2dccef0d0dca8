"""paddle_tpu_torch cached dense ``generate`` against the JAX package.

``llama_tiny`` and ``gpt2_tiny`` are built in ``paddle_tpu`` from a seed
and carried across with ``llama_from_jax_state`` / ``gpt_from_jax_state``.
On the CPU in f32: greedy ``generate`` equals JAX's token for token on both
of the port's trunks, eos padding included; ``forward(caches=,
cache_pos=)`` logits and the cache's ``[B, Hkv, T, D]`` view (the port's
cache is page pools, JAX's contiguous buffers) match JAX's to 1e-4 at a
prefill and at three one-token steps; seeded sampling is reproducible.
"""

import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models.gpt import gpt2_tiny as jax_gpt2_tiny
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu_torch.models import (LlamaConfig, gpt_from_jax_state,
                                     llama_from_jax_state)
from paddle_tpu_torch.models.generation import (CACHE_PAGE, cache_table,
                                                cache_view)
from paddle_tpu_torch.models.gpt import GPTConfig

TOL = dict(rtol=1e-4, atol=1e-4)
PROMPTS = np.asarray([[5, 9, 11, 2, 7], [3, 1, 4, 1, 5]], np.int64)


def _carry(jm, kind):
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    if kind == "llama":
        return llama_from_jax_state(
            state, LlamaConfig(**dataclasses.asdict(jm.cfg)), device="cpu")
    return gpt_from_jax_state(state, GPTConfig(**dataclasses.asdict(jm.cfg)),
                              device="cpu")


@pytest.fixture(scope="module")
def pairs():
    paddle.seed(11)
    jl = jax_llama_tiny()
    paddle.seed(12)
    jg = jax_gpt2_tiny()
    return {"llama": (jl, _carry(jl, "llama")),
            "gpt": (jg, _carry(jg, "gpt"))}


@pytest.mark.parametrize("kind", ["llama", "gpt"])
def test_greedy_generate_matches_jax(pairs, kind):
    jm, tm = pairs[kind]
    want = np.asarray(jm.generate(PROMPTS, max_new_tokens=10))
    for fused in (True, False):
        tm.fused_blocks = fused
        got = tm.generate(torch.from_numpy(PROMPTS), max_new_tokens=10)
        np.testing.assert_array_equal(got.numpy(), want)
    tm.fused_blocks = True
    # the exact-length host loop is the same function
    np.testing.assert_array_equal(
        tm.generate(PROMPTS, max_new_tokens=10, use_cache=False).numpy(),
        want)


def test_cached_forward_and_cache_match_jax(pairs):
    """Prefill of 9 tokens at position 0, then three one-token steps: the
    logits, and every layer's cache as ``[B, Hkv, T, D]``, against JAX's
    (the port's T is rounded up to 16, JAX's to its kernel's block)."""
    jm, tm = pairs["llama"]
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 512, size=(2, 12)).astype(np.int64)
    total = 14
    jc = jm.init_cache(2, total)
    tc = tm.init_cache(2, total)
    assert len(tc) == len(jc)
    assert tc[0][0].shape[0] == 2 * -(-total // CACHE_PAGE)
    assert tuple(cache_table(tc[0], 2).shape) == (2, 1)
    for start, stop in ((0, 9), (9, 10), (10, 11), (11, 12)):
        jl, jc = jm(paddle.to_tensor(ids[:, start:stop]), caches=jc,
                    cache_pos=Tensor(np.int64(start)))
        with torch.no_grad():
            tl, tc2 = tm(torch.from_numpy(ids[:, start:stop]), caches=tc,
                         cache_pos=start)
        assert tc2 is tc                   # the pools are written in place
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl.numpy()), **TOL)
        for (jk, jv), layer in zip(jc, tc):
            k, v = cache_view(layer, 2)
            for got, want in ((k, jk), (v, jv)):
                np.testing.assert_allclose(
                    got.numpy()[:, :, :stop],
                    np.asarray(want.numpy())[:, :, :stop], **TOL)


@pytest.mark.parametrize("fused", [True, False])
def test_gpt_cached_steps_equal_whole_forwards(pairs, fused):
    """GPT's cached forward (a prefill, then one-token steps, the middle
    step of two tokens through the composite) gives the whole-sequence
    forward's logits at every position."""
    _, tm = pairs["gpt"]
    tm.fused_blocks = fused
    ids = torch.from_numpy(np.random.default_rng(6).integers(
        0, 1024, size=(2, 12)))
    try:
        with torch.no_grad():
            full = tm(ids)
            caches = tm.init_cache(2, 12)
            for start, stop in ((0, 7), (7, 8), (8, 10), (10, 11),
                                (11, 12)):
                got, _ = tm(ids[:, start:stop], caches=caches,
                            cache_pos=start)
                torch.testing.assert_close(got, full[:, start:stop], **TOL)
    finally:
        tm.fused_blocks = True


def test_eos_padding_matches_jax(pairs):
    """A row that emits eos keeps emitting it; once every row has, the
    rest of the buffer is eos: the same buffer as JAX's."""
    jm, tm = pairs["llama"]
    ref = np.asarray(jm.generate(PROMPTS[:1], max_new_tokens=10))
    eos = int(ref[0, PROMPTS.shape[1] + 3])
    want = np.asarray(jm.generate(PROMPTS, max_new_tokens=10,
                                  eos_token_id=eos))
    got = tm.generate(torch.from_numpy(PROMPTS), max_new_tokens=10,
                      eos_token_id=eos).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tm.generate(PROMPTS[:1], max_new_tokens=10, eos_token_id=eos)
        .numpy()[0, PROMPTS.shape[1] + 3:], eos)
