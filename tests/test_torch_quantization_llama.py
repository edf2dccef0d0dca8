"""A PTQ-converted ``llama_tiny`` in paddle_tpu_torch against the JAX package's,
on the CPU (beside ``test_torch_quantization.py``, whose helpers it
shares): the model carried across with ``llama_from_jax_state``, both
calibrated with an absmax observer on the same ids and converted to
``Int8WeightOnlyLinear``; logits to 1e-4 relative, greedy tokens exact.
"""

import dataclasses

import numpy as np
import torch

import paddle_tpu as paddle
import paddle_tpu.quantization as JQZ
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu_torch.models import LlamaConfig, llama_from_jax_state
from paddle_tpu_torch import quantization as TQZ

from test_torch_quantization import (  # noqa: F401 — shared helpers
    _close, cpu_rule)


def test_llama_tiny_ptq_equals_jax():
    paddle.seed(11)
    jm = jax_llama_tiny()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = llama_from_jax_state(state, LlamaConfig(**dataclasses.asdict(
        jm.cfg)), device="cpu")
    ids = np.asarray([[5, 9, 11, 2, 7, 3, 1, 4]], np.int64)
    jptq = JQZ.PTQ(JQZ.QuantConfig(activation=JQZ.AbsmaxObserver(),
                                   weight=None))
    tptq = TQZ.PTQ(TQZ.QuantConfig(activation=TQZ.AbsmaxObserver(),
                                   weight=None))
    jc, tc = jptq.quantize(jm), tptq.quantize(tm)
    jc(paddle.to_tensor(ids))
    with torch.no_grad():
        tc(torch.from_numpy(ids))
    j8, t8 = jptq.convert(jc), tptq.convert(tc)
    n8 = [m for m in t8.modules() if isinstance(m, TQZ.Int8WeightOnlyLinear)]
    assert len(n8) == 7 * jm.cfg.num_layers + (0 if tm.lm_head is None
                                               else 1)
    with torch.no_grad():
        got = t8(torch.from_numpy(ids))
    _close(got, j8(paddle.to_tensor(ids)), 1e-4)
    prompts = np.asarray([[5, 9, 11, 2, 7], [3, 1, 4, 1, 5]], np.int64)
    want = np.asarray(j8.generate(prompts, max_new_tokens=6))
    got = t8.generate(torch.from_numpy(prompts), max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), want)
    # the float model is untouched (inplace=False) and differs
    assert not any(isinstance(m, TQZ.Int8WeightOnlyLinear)
                   for m in tm.modules())
