"""paddle_tpu_torch's Qwen2-MoE (``models/qwen2_moe.py``) and ``generate``
(``models/generation.py``) against the JAX package's, on the CPU.

A JAX ``qwen2_moe_tiny`` (2 layers, hidden 32, 4 experts, top-2, a shared
expert) or a tiny ``deepseek_moe`` (a dense first layer, 8 experts, top-3)
is built from a seed, at ``capacity_factor=0.5`` so that routed slots are
dropped, and carried across with ``qwen2_moe_from_jax_state``. The JAX side
runs its vmap expert path (what a CPU takes) or, with
``force_interpret(True)``, its grouped Pallas kernel in interpret mode;
the port runs its plain versions (no launch is counted on the CPU).
Tolerances: 1e-5 relative on logits, losses and ``l_aux`` (the same f32
math in another order), 1e-4 relative (1e-6 absolute) on every gradient;
after an AdamW step, 1e-6 absolute on every weight whose gradient exceeds
1e-6, and 1e-4 (a tenth of the learning rate, as
``tests/test_torch_training.py`` holds its steps) on the rest: Adam's
first step moves an entry by about ``lr * g / (|g| + epsilon)``, so an
entry whose gradient is a few f32 roundings (~1e-9 here) near ``epsilon``
(1e-8) steps apart in the two packages; greedy tokens exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import qwen2_moe as jq
from paddle_tpu.ops.kernels import _common as jax_kern
from paddle_tpu.ops.kernels import moe_gemm_pallas
from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
from paddle_tpu_torch.models import (Qwen2Moe, Qwen2MoeConfig,
                                     qwen2_moe_from_jax_state)
from paddle_tpu_torch.ops.kernels import WRAPPERS

LOGIT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
WEIGHT_TOL = dict(rtol=1e-4, atol=1e-4)
LINEAR = ("_proj.weight", "lm_head.weight", "gate.gate.weight")
VOCAB = 256
TINY_DEEPSEEK = dict(vocab_size=VOCAB, max_position_embeddings=64,
                     hidden_size=32, num_layers=2, num_heads=4,
                     num_kv_heads=2, num_experts=8, num_experts_per_tok=3,
                     moe_intermediate_size=16,
                     shared_expert_intermediate_size=32,
                     dense_intermediate_size=64)


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    for w in WRAPPERS.values():
        w.launches = 0
    yield
    assert all(w.launches == 0 for w in WRAPPERS.values())


def _jax_state(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _as_port(name, arr):
    return arr.T if name.endswith(LINEAR) else arr


def _models(kind="qwen2", seed=7, **kw):
    paddle.seed(seed)
    kw.setdefault("capacity_factor", 0.5)
    jm = jq.qwen2_moe_tiny(**kw) if kind == "qwen2" else \
        jq.deepseek_moe(**{**TINY_DEEPSEEK, **kw})
    tm = qwen2_moe_from_jax_state(
        _jax_state(jm), Qwen2MoeConfig(**dataclasses.asdict(jm.cfg)),
        device="cpu")
    return jm, tm


def _batch(seed, b=2, s=12):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, VOCAB, (b, s + 1))
    return toks[:, :-1].astype(np.int64), toks[:, 1:].astype(np.int64)


def test_from_jax_state_round_trips():
    """Every key arrives: linear weights (attention, shared experts, the
    router, the head) transposed, the stacked experts as they are."""
    paddle.seed(1)
    jm = jq.deepseek_moe(**TINY_DEEPSEEK)
    state = _jax_state(jm)
    tm = qwen2_moe_from_jax_state(
        state, Qwen2MoeConfig(**dataclasses.asdict(jm.cfg)), device="cpu")
    got = {k: v.numpy() for k, v in tm.state_dict().items()}
    assert set(got) == set(state)
    for name, arr in state.items():
        np.testing.assert_array_equal(_as_port(name, got[name]), arr,
                                      err_msg=name)
    assert tm.layers[0].is_dense and not tm.layers[1].is_dense
    assert tuple(tm.layers[1].mlp.expert_0.shape) == (8, 32, 16)
    bad = dict(state)
    bad.pop("layers.1.mlp.expert_2")
    with pytest.raises(KeyError, match="expert_2"):
        qwen2_moe_from_jax_state(bad, tm.cfg, device="cpu")
    bad = dict(state)
    bad["layers.1.mlp.expert_0"] = state["layers.1.mlp.expert_0"][:, :, :8]
    with pytest.raises(ValueError, match="expert_0"):
        qwen2_moe_from_jax_state(bad, tm.cfg, device="cpu")


@pytest.mark.parametrize("jax_path", ["vmap", "grouped"])
@pytest.mark.parametrize("kind", ["qwen2", "deepseek"])
def test_logits_loss_and_gradients_match_jax(kind, jax_path, monkeypatch):
    """Logits, ``l_aux``, the loss with ``router_aux_loss_coef * l_aux``
    and every parameter's gradient, with capacity drops, against JAX's
    vmap expert path and its grouped kernel (reached on every MoE layer,
    forward and backward)."""
    reached = []
    real = moe_gemm_pallas._grouped_call

    def counted(*a, **kw):
        reached.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(moe_gemm_pallas, "_grouped_call", counted)
    jax_kern.force_interpret(jax_path == "grouped")
    try:
        jm, tm = _models(kind, seed=3)
        ids, labels = _batch(1)
        labels[:, :2] = -100
        jlogits, jloss = jm(paddle.to_tensor(ids),
                            labels=paddle.to_tensor(labels))
        jloss.backward()
    finally:
        jax_kern.force_interpret(False)
    logits, loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(jlogits.numpy()), **LOGIT_TOL)
    np.testing.assert_allclose(tm.l_aux.item(), float(jm.l_aux.numpy()),
                               **LOGIT_TOL)
    np.testing.assert_allclose(loss.item(), float(jloss.numpy()), **LOGIT_TOL)
    got = dict(tm.named_parameters())
    want = {n: _as_port(n, np.asarray(p.grad.numpy()))
            for n, p in jm.named_parameters()}
    assert set(got) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), g, **GRAD_TOL,
                                   err_msg=name)
    n_moe = sum(not layer.is_dense for layer in tm.layers)
    # 3 products a MoE layer forward; dx of each in the backward
    assert len(reached) == (6 * n_moe if jax_path == "grouped" else 0)


def test_capacity_drops_happen_in_the_tiny_model():
    """``capacity_factor=0.5``: fewer slots than routed tokens, so the
    parity above covers the drop and the arrival order."""
    _, tm = _models("qwen2", seed=3)
    moe = tm.layers[0].mlp
    n, k, e = 2 * 12, moe.top_k, moe.num_expert
    assert int(np.ceil(0.5 * n * k / e)) * e < n * k


def test_config_errors_match_jax():
    for kw in (dict(num_experts=0), dict(num_experts=2,
                                         num_experts_per_tok=4)):
        with pytest.raises(ValueError) as theirs:
            jq.Qwen2MoeConfig(**kw)
        with pytest.raises(ValueError) as ours:
            Qwen2MoeConfig(**kw)
        assert str(ours.value).split(" — ")[0] == \
            str(theirs.value).split(" — ")[0]
    cfg = Qwen2MoeConfig()
    assert cfg.head_dim == 128 and cfg.as_llama().intermediate_size == 5632


@pytest.mark.parametrize("kind", ["qwen2", "deepseek"])
def test_sizes_and_flops_match_jax(kind):
    jm, tm = _models(kind)
    assert tm.num_params() == jm.num_params()
    assert tm.num_activated_params() == jm.num_activated_params()
    assert tm.flops_per_token(16) == pytest.approx(jm.flops_per_token(16))


def test_full_size_qwen1_5_moe_counts():
    """``Qwen2MoeConfig()`` at the published Qwen1.5-MoE-A2.7B widths, built
    on the meta device (no memory): 14.32 B parameters, 2.69 B activated a
    token."""
    m = Qwen2Moe(Qwen2MoeConfig(), device="meta", seed=None)
    assert m.num_params() == 14_315_589_024
    assert round(m.num_activated_params() / 1e9, 2) == 2.69
    moe = m.layers[0].mlp
    assert isinstance(moe, MoELayer) and moe._ffn_fast
    assert tuple(moe.expert_0.shape) == (60, 2048, 1408)
    assert tuple(moe.expert_2.shape) == (60, 1408, 2048)
