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
from paddle_tpu.incubate.distributed.models import moe as jax_moe
from paddle_tpu.models import qwen2_moe as jq
from paddle_tpu.ops.kernels import _common as jax_kern
from paddle_tpu.ops.kernels import moe_gemm_pallas
from paddle_tpu_torch.incubate.distributed.models.moe import (
    ClipGradForMOEByGlobalNorm, MoELayer)
from paddle_tpu_torch.models import (Qwen2Moe, Qwen2MoeConfig, deepseek_moe,
                                     generate, llama_tiny,
                                     qwen2_moe_from_jax_state, qwen2_moe_tiny)
from paddle_tpu_torch.ops.kernels import WRAPPERS
from paddle_tpu_torch.optimizer import AdamW

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


# -- generate -------------------------------------------------------------------

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
