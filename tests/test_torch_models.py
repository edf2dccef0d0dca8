"""paddle_tpu_torch Llama and serving model against the JAX package.

A ``llama_tiny`` is built in ``paddle_tpu`` from a seed and its
``state_dict()`` carried across as numpy with ``llama_from_jax_state``;
the serving model's prefill-chunk and decode logits must then match the
JAX ``ServingModel(fused_block=False)`` on the CPU in f32 to 1e-4 (the
same math, summed in another order through a few layers).
"""

import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu.serving import kv_cache as jax_kv
from paddle_tpu.serving.model import ServingModel as JaxServingModel
from paddle_tpu_torch.models import LlamaConfig, llama_from_jax_state
from paddle_tpu_torch.serving import PagePool, ServingModel

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9]


@pytest.fixture(scope="module")
def models():
    paddle.seed(11)
    jm = jax_llama_tiny()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    cfg = LlamaConfig(**dataclasses.asdict(jm.cfg))
    return jm, llama_from_jax_state(state, cfg, device="cpu")


def test_converter_transposes_linear_weights_only(models):
    jm, tm = models
    jsd = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tsd = tm.state_dict()
    assert set(jsd) == set(tsd)
    for name, arr in jsd.items():
        got = tsd[name].numpy()
        want = arr.T if name.endswith(("_proj.weight", "lm_head.weight")) \
            else arr
        np.testing.assert_array_equal(got, want)
    with pytest.raises(KeyError):
        llama_from_jax_state({k: v for k, v in jsd.items()
                              if k != "norm.weight"}, tm.cfg, device="cpu")


def test_serving_logits_match_jax(models):
    jm, tm = models
    cfg = jm.cfg
    shape = (cfg.num_layers, 17, cfg.num_kv_heads, 8, cfg.head_dim)
    jsm = JaxServingModel(jm, fused_block=False).bind_pool(
        jax_kv.PagePool(*shape))
    tsm = ServingModel(tm, fused_block=False).bind_pool(PagePool(*shape))
    max_pages = 16
    # two 13-token requests, each prefilled in chunks of 8 and 5 tokens
    tables = np.zeros((3, max_pages), np.int32)
    tables[0, :2] = [4, 9]
    tables[2, :2] = [2, 11]
    prompts = {0: PROMPT, 2: PROMPT[::-1]}
    nxt = np.zeros(3, np.int32)
    for r, prompt in prompts.items():
        for start, n in ((0, 8), (8, 5)):
            toks = np.zeros((1, 8), np.int32)
            toks[0, :n] = prompt[start:start + n]
            want = jsm.prefill_chunk_forward(
                paddle.to_tensor(toks), paddle.to_tensor(np.int32(start)),
                paddle.to_tensor(np.int32(n)), paddle.to_tensor(tables[r]))
            got = tsm.prefill_chunk_forward(torch.from_numpy(toks), start, n,
                                            torch.from_numpy(tables[r]))
            np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                                       **LOGIT_TOL)
        nxt[r] = int(np.asarray(want.numpy()).argmax())

    # one decode step: rows 0 and 2 continue at position 13, row 1 is an
    # inactive slot (position 0, all-trash table)
    positions = np.asarray([13, 0, 13], np.int32)
    want = jsm.decode_forward(paddle.to_tensor(nxt),
                              paddle.to_tensor(positions),
                              paddle.to_tensor(tables))
    got = tsm.decode_forward(torch.from_numpy(nxt),
                             torch.from_numpy(positions),
                             torch.from_numpy(tables))
    assert np.isfinite(got.numpy()).all()
    for r in prompts:
        np.testing.assert_allclose(got.numpy()[r],
                                   np.asarray(want.numpy())[r], **LOGIT_TOL)
