"""paddle_tpu_torch's Qwen2-MoE training against the JAX package's, on the CPU
(split from ``test_torch_qwen2_moe.py``, whose helpers and tolerances it
shares): one AdamW step under the MoE clip, and a loss that falls over
fresh batches.
"""


import numpy as np
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.distributed.models import moe as jax_moe
from paddle_tpu_torch.incubate.distributed.models.moe import \
    ClipGradForMOEByGlobalNorm
from paddle_tpu_torch.models import qwen2_moe_tiny
from paddle_tpu_torch.optimizer import AdamW

from test_torch_qwen2_moe import (  # noqa: F401 — shared helpers
    LOGIT_TOL, WEIGHT_TOL, _as_port, _batch, _jax_state, _models,
    _no_launches_on_cpu)


def test_adamw_step_with_moe_clip_matches_jax():
    """One AdamW step under ``ClipGradForMOEByGlobalNorm(1.0)`` (each
    ``[E, ...]`` stack one parameter): the same loss and weights."""
    jm, tm = _models("qwen2", seed=5)
    jopt = paddle.optimizer.AdamW(
        1e-3, parameters=jm.parameters(), weight_decay=0.01, fuse=False,
        grad_clip=jax_moe.ClipGradForMOEByGlobalNorm(1.0))
    opt = AdamW(1e-3, parameters=tm.parameters(), weight_decay=0.01,
                grad_clip=ClipGradForMOEByGlobalNorm(1.0))
    ids, labels = _batch(10)
    _, jloss = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    jloss.backward()
    jopt.step()
    _, loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    grads = {n: p.grad.clone() for n, p in tm.named_parameters()}
    opt.step()
    np.testing.assert_allclose(loss.item(), float(jloss.numpy()),
                               **LOGIT_TOL)
    got = tm.state_dict()
    for name, w in _jax_state(jm).items():
        w = _as_port(name, w)
        np.testing.assert_allclose(got[name].numpy(), w, **WEIGHT_TOL,
                                   err_msg=name)
        big = grads[name].abs().numpy() > 1e-6
        np.testing.assert_allclose(got[name].numpy()[big], w[big], rtol=0,
                                   atol=1e-6, err_msg=name)


def test_loss_falls_over_fresh_batches():
    """As ``tests/test_models.py::test_qwen2_moe_trains_and_activated_params``
    trains the JAX model: 12 AdamW steps at 1e-2, here on a fresh batch of
    counting sequences each step; the loss falls by more than 0.3 and the
    aux loss is set."""
    model = qwen2_moe_tiny(device="cpu", seed=0)
    opt = AdamW(1e-2, parameters=model.parameters(),
                grad_clip=ClipGradForMOEByGlobalNorm(1.0))
    losses = []
    for step in range(12):
        rng = np.random.default_rng(100 + step)
        toks = (rng.integers(0, 32, (4, 1)) + np.arange(17)[None]) % 32
        ids = torch.from_numpy(toks[:, :-1])
        _, loss = model(ids, labels=torch.from_numpy(toks[:, 1:]))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    assert losses[-1] < losses[0] - 0.3, losses
    assert model.l_aux is not None
    assert model.num_activated_params() < model.num_params()
