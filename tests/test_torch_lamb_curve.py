"""paddle_tpu_torch's Lamb loss curve on GPT against the JAX package's, on the
CPU (split from ``test_torch_lamb.py``, whose helpers and tolerances it
shares).
"""

import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import topology
from paddle_tpu.distributed.meta_parallel import \
    ParallelCrossEntropy as JaxPCE
from paddle_tpu.models.gpt import gpt2_tiny as jax_gpt2_tiny
from paddle_tpu.ops.kernels import _common as jax_kern
from paddle_tpu_torch.distributed import ParallelCrossEntropy
from paddle_tpu_torch.models import GPTConfig, gpt_from_jax_state
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import Lamb
from paddle_tpu_torch.optimizer import lr as tlr

from test_torch_lamb import (  # noqa: F401 — shared helpers
    CURVE_RTOL, _batch, _no_launches_on_cpu, _schedule)


@pytest.fixture(autouse=True)
def _no_global_mesh():
    """The JAX model's ``mark_sharding`` places onto whatever mesh an
    earlier test file in this process left active: start from none."""
    topology.reset_topology_state()
    yield


def test_gpt_lamb_curve_matches_jax():
    """GPT-2 tiny on the fused trunk, 20 steps of chip_smoke's train_lamb
    recipe in f32 (Lamb, lamb_weight_decay 0.01, 1-D parameters excluded
    from the decay, a global-norm clip of 1.0, LinearWarmup(
    CosineAnnealingDecay(2e-3, T_max=8)) stepped each iteration, the loss
    ``ParallelCrossEntropy()(logits, labels).mean()``) over fresh batches
    of counting sequences, port and JAX in lockstep: every loss within
    CURVE_RTOL and the curve falls. The JAX side runs its Lamb and
    cross-entropy kernels in interpret mode."""
    flags = paddle.get_flags(["use_fused_blocks"])
    jax_kern.force_interpret(True)
    paddle.set_flags({"use_fused_blocks": 1})
    peak = 2e-3
    try:
        paddle.seed(11)
        jm = jax_gpt2_tiny()
        state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
        tm = gpt_from_jax_state(state, GPTConfig(**dataclasses.asdict(jm.cfg)),
                                device="cpu")
        tm.fused_blocks = True
        jsched, tsched = _schedule(paddle.optimizer.lr, peak), \
            _schedule(tlr, peak)
        jopt = paddle.optimizer.Lamb(
            learning_rate=jsched, lamb_weight_decay=0.01,
            exclude_from_weight_decay_fn=lambda p: p.ndim == 1,
            parameters=jm.parameters(), fuse=False,
            grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
        opt = Lamb(learning_rate=tsched, lamb_weight_decay=0.01,
                   exclude_from_weight_decay_fn=lambda p: p.ndim == 1,
                   parameters=tm.parameters(),
                   grad_clip=ClipGradByGlobalNorm(1.0))
        jce, tce = JaxPCE(), ParallelCrossEntropy()
        jl, tl = [], []
        for step in range(20):
            ids, labels = _batch(300 + step)
            jloss = jce(jm(paddle.to_tensor(ids)),
                        paddle.to_tensor(labels)).mean()
            jloss.backward()
            jopt.step()
            jopt.clear_grad()
            jsched.step()
            loss = tce(tm(torch.from_numpy(ids)),
                       torch.from_numpy(labels)).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            tsched.step()
            assert opt.get_lr() == jopt.get_lr()
            jl.append(float(jloss.numpy()))
            tl.append(loss.item())
    finally:
        paddle.set_flags(flags)
        jax_kern.force_interpret(False)
    np.testing.assert_allclose(tl, jl, rtol=CURVE_RTOL, atol=0)
    # Lamb at a 2e-3 peak moves each weight by ~0.2% of its tensor's norm
    # a step: the loss falls ~0.45 from ln(1024) = 6.93 in 20 steps
    assert tl[-1] < tl[0] - 0.3, tl
