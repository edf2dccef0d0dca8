"""paddle_tpu_torch's GPT loss curve over fresh batches against the JAX package's,
on the CPU (split from ``test_torch_gpt.py``, whose helpers and tolerances
it shares).
"""


import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import topology
from paddle_tpu.ops.kernels import _common as jax_kern
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW

from test_torch_gpt import (  # noqa: F401 — shared helpers
    CURVE_RTOL, _batch, _models, _no_launches_on_cpu)


@pytest.fixture(autouse=True)
def _no_global_mesh():
    """The JAX model's ``mark_sharding`` places onto whatever mesh an
    earlier test file in this process left active: start from none."""
    topology.reset_topology_state()
    yield


def test_loss_curve_over_fresh_batches_matches_jax():
    """BASELINE config #1's "loss matches reference curve" at tiny size:
    20 AdamW steps (global-norm clip 1.0) on the fused trunk, a fresh
    batch of counting sequences over 32 tokens each step, port and JAX in
    lockstep; every step's loss within CURVE_RTOL, and the curve falls."""
    flags = paddle.get_flags(["use_fused_blocks"])
    jax_kern.force_interpret(True)
    paddle.set_flags({"use_fused_blocks": 1})
    try:
        jm, tm = _models(seed=3, fused=True)
        jopt = paddle.optimizer.AdamW(
            3e-3, parameters=jm.parameters(), weight_decay=0.01, fuse=False,
            grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
        opt = AdamW(3e-3, parameters=tm.parameters(), weight_decay=0.01,
                    grad_clip=ClipGradByGlobalNorm(1.0))
        jl, tl = [], []
        for step in range(20):
            ids, labels = _batch(100 + step, b=4, mod=32)
            _, jloss = jm(paddle.to_tensor(ids),
                          labels=paddle.to_tensor(labels))
            jloss.backward()
            jopt.step()
            jopt.clear_grad()
            _, loss = tm(torch.from_numpy(ids),
                         labels=torch.from_numpy(labels))
            loss.backward()
            opt.step()
            opt.clear_grad()
            jl.append(float(jloss.numpy()))
            tl.append(loss.item())
    finally:
        paddle.set_flags(flags)
        jax_kern.force_interpret(False)
    np.testing.assert_allclose(tl, jl, rtol=CURVE_RTOL, atol=0)
    assert tl[-1] < tl[0] - 1.0, tl
