"""paddle_tpu_torch's Qwen2-MoE ``generate`` against the JAX package's, on the CPU
(split from ``test_torch_qwen2_moe.py``, whose helpers and tolerances it
shares): greedy tokens and eos padding exactly, the generate errors, seeded
sampling reproducible, and DeepSeek-MoE generating.
"""

import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import qwen2_moe as jq
from paddle_tpu_torch.models import (Qwen2MoeConfig, deepseek_moe, generate,
                                     llama_tiny, qwen2_moe_from_jax_state,
                                     qwen2_moe_tiny)

from test_torch_qwen2_moe import (  # noqa: F401 — shared helpers
    TINY_DEEPSEEK, VOCAB, _jax_state, _no_launches_on_cpu)


@pytest.fixture(scope="module")
def jax_generated():
    """One JAX model and its greedy ``generate`` on a batch of 2 (2 new
    tokens; the JAX host loop compiles once per length), with and without
    an eos token, and its unpadded forward's last-position argmax."""
    paddle.seed(21)
    jm = jq.qwen2_moe_tiny(capacity_factor=0.5)
    prompt = np.random.default_rng(0).integers(0, VOCAB, (2, 5))
    out = np.asarray(jm.generate(paddle.to_tensor(prompt), max_new_tokens=2))
    eos = int(out[0, 5])
    out_eos = np.asarray(jm.generate(paddle.to_tensor(prompt),
                                     max_new_tokens=2, eos_token_id=eos))
    with paddle.no_grad():
        logits = np.asarray(jm(paddle.to_tensor(prompt)).numpy())
    argmax = logits[:, -1].argmax(-1)
    return dict(state=_jax_state(jm), cfg=dataclasses.asdict(jm.cfg),
                prompt=prompt, out=out, eos=eos, out_eos=out_eos,
                argmax=argmax)


def _port_of(gen):
    return qwen2_moe_from_jax_state(gen["state"], Qwen2MoeConfig(**gen["cfg"]),
                                    device="cpu")


def test_greedy_tokens_equal_jax(jax_generated):
    g = jax_generated
    tm = _port_of(g)
    out = tm.generate(torch.from_numpy(g["prompt"]), max_new_tokens=2)
    assert out.dtype == torch.int64 and tuple(out.shape) == (2, 7)
    np.testing.assert_array_equal(out.numpy(), g["out"])
    # the first emitted token is the unpadded forward's argmax, in both
    np.testing.assert_array_equal(g["out"][:, 5], g["argmax"])
    with torch.no_grad():
        logits = tm(torch.from_numpy(g["prompt"]))
    np.testing.assert_array_equal(out[:, 5].numpy(),
                                  logits[:, -1].argmax(-1).numpy())
    # a list prompt and the module-level function give the same buffer
    np.testing.assert_array_equal(
        generate(tm, g["prompt"].tolist(), max_new_tokens=2).numpy(),
        g["out"])


def test_eos_padding_matches_jax(jax_generated):
    """Row 0 emits eos at once and keeps emitting it; the buffer equals
    JAX's. With one row, the loop stops after that token and the tail is
    eos."""
    g = jax_generated
    tm = _port_of(g)
    eos = g["eos"]
    out = tm.generate(torch.from_numpy(g["prompt"]), max_new_tokens=2,
                      eos_token_id=eos)
    np.testing.assert_array_equal(out.numpy(), g["out_eos"])
    assert (out[0, 5:] == eos).all()
    calls = []
    hook = tm.register_forward_hook(lambda *a: calls.append(1))
    try:
        one = tm.generate(torch.from_numpy(g["prompt"][:1]),
                          max_new_tokens=6, eos_token_id=eos)
    finally:
        hook.remove()
    assert len(calls) == 1
    assert (one[0, 5:] == eos).all() and tuple(one.shape) == (1, 11)


def test_generate_errors_and_training_mode():
    model = qwen2_moe_tiny(device="cpu", seed=1)
    ids = torch.zeros(1, 60, dtype=torch.long)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        model.generate(ids, max_new_tokens=5)
    model.train()
    with pytest.raises(ValueError, match="top_k"):
        model.generate(ids[:, :4], max_new_tokens=2, do_sample=True, top_k=0)
    assert model.training
    out = model.generate(ids[:, :4], max_new_tokens=2)
    assert model.training and tuple(out.shape) == (1, 6)
    model.eval()
    model.generate(ids[:, :4], max_new_tokens=1)
    assert not model.training
    dense = llama_tiny(device="cpu", seed=0)
    dense.train()
    # dense models decode with their KV cache now
    assert tuple(generate(dense, ids[:, :4], max_new_tokens=2).shape) == \
        (1, 6)
    assert dense.training


def test_seeded_sampling_is_reproducible():
    model = qwen2_moe_tiny(device="cpu", seed=2)
    p = torch.tensor([[1, 2, 3]])
    kw = dict(max_new_tokens=8, do_sample=True, temperature=2.0)
    a = model.generate(p, seed=5, **kw)
    assert torch.equal(a, model.generate(p, seed=5, **kw))
    assert not torch.equal(a, model.generate(p, seed=6, **kw))
    # unseeded calls take a process counter: they differ from each other
    assert not torch.equal(model.generate(p, **kw), model.generate(p, **kw))
    # top_k = 1 sampling is greedy
    np.testing.assert_array_equal(
        model.generate(p, max_new_tokens=4, do_sample=True, top_k=1,
                       seed=9).numpy(),
        model.generate(p, max_new_tokens=4).numpy())


def test_deepseek_generates():
    model = deepseek_moe(device="cpu", seed=3, **TINY_DEEPSEEK)
    out = model.generate(torch.tensor([[4, 5, 6], [7, 8, 9]]),
                         max_new_tokens=2)
    assert tuple(out.shape) == (2, 5) and (out >= 0).all()
