"""Quantized serving in paddle_tpu_torch (``ServingConfig(quant=...)``)
against the JAX serving engine, on the CPU.

A JAX ``llama_tiny`` is built from a seed and its ``state_dict()`` carried
across with ``llama_from_jax_state``; both engines quantize the same f32
weights (byte-equal, ``tests/test_torch_quant.py``) and greedy tokens must
be equal. On the CPU the port's weight-only wrappers take their plain
versions and the JAX engine its composite; the fused-layer case runs the
JAX decode-layer kernel in interpret mode with tuning off, as
``tests/test_decode_layer_fused.py`` does.
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
from paddle_tpu_torch.models import LlamaConfig, llama_from_jax_state
from paddle_tpu_torch.ops.kernels import WRAPPERS, autotune
from paddle_tpu_torch.serving import (LLMEngine, ServingConfig, ServingModel,
                                      model_fingerprint)

_CFG = dict(page_size=8, num_pages=32, max_batch=4, max_new_tokens=6,
            max_seq_len=64)
_PROMPTS = [[3, 5, 7, 11], [2, 4, 6], [9, 9, 1, 2, 3]]
_QUANTS = [("weight_only_int8", -1), ("weight_only_int4", -1),
           ("weight_only_int8", 4), ("weight_only_int4", 4)]


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = jax_llama_tiny()
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    cfg = LlamaConfig(**dataclasses.asdict(jm.cfg))
    return jm, llama_from_jax_state(state, cfg, device="cpu")


@pytest.fixture
def no_tune(monkeypatch, tmp_path):
    monkeypatch.setenv("PADDLE_TPU_TUNE", "0")
    monkeypatch.setenv("PADDLE_TPU_TUNE_CACHE",
                       str(tmp_path / "tuning_cache.json"))


def _jax_tokens(jm, prompts, interpret=False, **cfg):
    jax_kern.force_interpret(interpret)
    try:
        eng = JaxEngine(jm, JaxConfig(**{**_CFG, **cfg}))
        out = [eng.generate(p) for p in prompts]
        eng.shutdown(drain=True)
    finally:
        jax_kern.force_interpret(False)
    return out


def _port(tm, prompts, **cfg):
    """(tokens, stats, shutdown summary, engine) of the port's engine; the
    prompts are submitted together."""
    eng = LLMEngine(tm, ServingConfig(**{**_CFG, **cfg}), device="cpu")
    try:
        got = [r.result(300) for r in [eng.submit(p) for p in prompts]]
        stats = eng.stats()
    finally:
        summary = eng.shutdown()
    return got, stats, summary, eng


@pytest.mark.parametrize("quant,group", _QUANTS)
def test_quant_engine_tokens_equal_jax(models, quant, group):
    jm, tm = models
    want = _jax_tokens(jm, _PROMPTS, quant=quant, quant_group_size=group)
    for w in WRAPPERS.values():
        w.launches = 0
    got, _, summary, eng = _port(tm, _PROMPTS, quant=quant,
                                 quant_group_size=group)
    assert got == want, (quant, group)
    assert eng._sm.quantized and summary["pages_leaked"] == 0
    assert all(w.launches == 0 for w in WRAPPERS.values())   # CPU: plain


def test_quant_engine_with_prefix_cache(models):
    """A repeated page-aligned prompt claims its pages; no page leaks; the
    tokens are the JAX engine's (``tests/test_prefix_cache.py:389``)."""
    jm, tm = models
    prompt = list(range(1, 21))               # two full pages at page size 8
    want = _jax_tokens(jm, [prompt, prompt], quant="weight_only_int8",
                       prefix_cache=True)
    eng = LLMEngine(tm, ServingConfig(**_CFG, quant="weight_only_int8"),
                    device="cpu")
    try:
        got = [eng.generate(prompt, timeout=300) for _ in range(2)]
        stats = eng.stats()["prefix_cache"]
    finally:
        summary = eng.shutdown()
    assert got == want and got[0] == got[1]
    assert stats["page_hits"] >= 2 and stats["tokens_saved"] > 0
    assert summary["pages_leaked"] == 0 and eng.pool.lost() == 0


def test_quant_decode_step_plain_equals_kernel_path(models):
    """``plain=True`` reaches the plain versions: on the CPU the same
    function as the default path, bit for bit."""
    _, tm = models
    from paddle_tpu_torch.serving import PagePool
    cfg = tm.cfg
    pool = PagePool(cfg.num_layers, 17, cfg.num_kv_heads, 8, cfg.head_dim)
    g = torch.Generator().manual_seed(0)
    pool.k.copy_(torch.randn(pool.k.shape, generator=g))
    pool.v.copy_(torch.randn(pool.v.shape, generator=g))
    sm = ServingModel(tm, quant="weight_only_int4").bind_pool(pool)
    args = (torch.tensor([7, 300]), torch.tensor([13, 20], dtype=torch.int32),
            torch.tensor([[4, 9, 0], [2, 11, 5]], dtype=torch.int32))
    got = sm.decode_forward(*args)
    assert torch.isfinite(got).all()
    np.testing.assert_array_equal(sm.decode_forward(*args, plain=True), got)
    float_sm = ServingModel(tm).bind_pool(pool)
    assert not torch.equal(float_sm.decode_forward(*args), got)


def test_fingerprints_change_with_quant_and_group(models):
    _, tm = models
    prints = {model_fingerprint(tm, quant=q, quant_group_size=g)
              for q, g in [(None, -1)] + _QUANTS}
    assert len(prints) == 1 + len(_QUANTS)
    eng = LLMEngine(tm, ServingConfig(**_CFG, quant="weight_only_int8",
                                      quant_group_size=4), device="cpu")
    try:
        assert eng.prefix_cache.fingerprint == model_fingerprint(
            tm, quant="weight_only_int8", quant_group_size=4,
            dtype="float32", page_size=8)
    finally:
        eng.shutdown()


def test_tuner_key_carries_quant(models, tmp_path, monkeypatch):
    """The decode-layer tuning entry of a quant engine is keyed and
    labelled with its quant layout (``autotune.py:266`` of the JAX
    package)."""
    _, tm = models
    monkeypatch.setenv("PADDLE_TPU_TUNE_CACHE", str(tmp_path / "tc.json"))
    eng = LLMEngine(tm, ServingConfig(**_CFG, fused_decode_layer=True,
                                      quant="weight_only_int4"),
                    device="cpu")
    try:
        cache = autotune.TuningCache()
        trial = lambda step, args, steps=2, warmup=1: 1.0  # noqa: E731
        entry = autotune.tune_for_serving(eng._sm, 8, 32,
                                          eng.scheduler.max_pages, 4,
                                          cache=cache, trial=trial)
        assert entry["quant"] == "int4"
        float_sm = ServingModel(tm, fused_decode_layer=True).bind_pool(
            eng.pool)
        again = autotune.tune_for_serving(float_sm, 8, 32,
                                          eng.scheduler.max_pages, 4,
                                          cache=cache, trial=trial)
        assert again["quant"] is None and cache.stats()["entries"] == 2
    finally:
        eng.shutdown()


def test_bad_quant_name_raises(models):
    _, tm = models
    with pytest.raises(ValueError, match="quant"):
        LLMEngine(tm, ServingConfig(**_CFG, quant="fp8"), device="cpu")
    with pytest.raises(ValueError, match="quant"):
        ServingModel(tm, quant="weight_only_int2")
    with pytest.raises(ValueError):
        LLMEngine(tm, ServingConfig(**_CFG, quant="weight_only_int8",
                                    quant_group_size=3), device="cpu")
