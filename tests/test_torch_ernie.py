"""paddle_tpu_torch's ERNIE (``models/ernie.py``) against the JAX package's,
on the CPU, and the mmha plain version at GQA ratios that are not powers of
two.

A JAX ``ernie_tiny`` (2 dense layers, 4 heads over 2 kv heads), a tiny rep-5
model (5 heads over 1 kv head, ERNIE-4.5's query-group size) and the same
with a MoE tail (one dense layer, then 4 experts, top-2, a shared expert,
``capacity_factor`` 2.0 as ``ErnieConfig.as_moe`` leaves it) are built from
a seed and carried across with ``ernie_from_jax_state``. Tolerances: 1e-5
relative (1e-6 absolute) on logits, losses and ``l_aux`` (the same f32 math
in another order; the port's dense model runs Llama's fused trunk, JAX's
its layer loop), 1e-4 relative on every gradient, 2e-4 on the mmha rows
(the JAX tests' f32 tolerance).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import ernie as je
from paddle_tpu.ops.kernels import mmha_pallas
from paddle_tpu_torch.models import (Ernie, ErnieConfig, ErniePretrainLoss,
                                     ernie_from_jax_state, ernie_tiny)
from paddle_tpu_torch.ops.kernels import WRAPPERS, mmha
from paddle_tpu_torch.serving import LLMEngine, ServingConfig
from paddle_tpu_torch.serving.model import ServingModel

LOGIT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
MMHA_TOL = dict(rtol=2e-4, atol=2e-4)
LINEAR = ("_proj.weight", "lm_head.weight", "gate.gate.weight")
VOCAB = 256
#: (JAX constructor keywords) of the three tiny models
CONFIGS = {
    "tiny": {},
    "rep5": dict(hidden_size=40, num_heads=5, num_kv_heads=1),
    "rep5_moe": dict(hidden_size=40, num_heads=5, num_kv_heads=1,
                     num_experts=4, num_experts_per_tok=2, first_k_dense=1,
                     moe_intermediate_size=16,
                     shared_expert_intermediate_size=32),
}


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    for w in WRAPPERS.values():
        w.launches = 0
    yield
    assert all(w.launches == 0 for w in WRAPPERS.values())


def _as_port(name, arr):
    return arr.T if name.endswith(LINEAR) else arr


@pytest.fixture(scope="module")
def models():
    """name -> (JAX model, port model), each built once."""
    out = {}
    for i, (name, kw) in enumerate(CONFIGS.items()):
        paddle.seed(11 + i)
        jm = je.ernie_tiny(**kw)
        state = {k: np.asarray(v.numpy()) for k, v in
                 jm.state_dict().items()}
        tm = ernie_from_jax_state(
            state, ErnieConfig(**dataclasses.asdict(jm.cfg)), device="cpu")
        out[name] = (jm, tm, state)
    return out


def _batch(seed, b=2, s=12):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, VOCAB, (b, s + 1))
    return toks[:, :-1].astype(np.int64), toks[:, 1:].astype(np.int64)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_from_jax_state_round_trips(models, name):
    """Every key arrives (a tied head: no ``lm_head``); dense layers carry
    Llama's keys, MoE layers Qwen2-MoE's (router transposed, stacked
    experts as they are); a missing key raises."""
    jm, tm, state = models[name]
    got = {k: v.numpy() for k, v in tm.state_dict().items()}
    assert set(got) == set(state) and "lm_head.weight" not in got
    for key, arr in state.items():
        np.testing.assert_array_equal(_as_port(key, got[key]), arr,
                                      err_msg=key)
    bad = dict(state)
    bad.pop("norm.weight")
    with pytest.raises(KeyError, match="norm.weight"):
        ernie_from_jax_state(bad, tm.cfg, device="cpu")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_logits_loss_aux_and_gradients_match_jax(models, name):
    """Logits, ``l_aux``, the loss (f32 cross entropy with ignored labels,
    plus ``router_aux_loss_coef * l_aux`` with a MoE tail) and, for the
    rep-5 models (the tiny one shares their code at rep 2), every
    gradient; ``ErniePretrainLoss`` is the same cross entropy."""
    jm, tm, _ = models[name]
    grads = name != "tiny"
    ids, labels = _batch(3)
    labels[:, :2] = -100
    jlogits, jloss = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    tm.zero_grad(set_to_none=True)
    logits, loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(jlogits.numpy()), **LOGIT_TOL)
    np.testing.assert_allclose(loss.item(), float(jloss.numpy()), **LOGIT_TOL)
    if jm.l_aux is None:
        assert tm.l_aux is None
    else:
        np.testing.assert_allclose(tm.l_aux.item(), float(jm.l_aux.numpy()),
                                   **LOGIT_TOL)
    if grads:
        jm.clear_gradients()
        jloss.backward()
        loss.backward()
        want = {n: _as_port(n, np.asarray(p.grad.numpy()))
                for n, p in jm.named_parameters()}
        got = dict(tm.named_parameters())
        assert set(got) == set(want)
        for key, g in want.items():
            np.testing.assert_allclose(got[key].grad.numpy(), g, **GRAD_TOL,
                                       err_msg=key)
    plain = ErniePretrainLoss(tm.cfg)(logits.detach(),
                                      torch.from_numpy(labels))
    theirs = je.ErniePretrainLoss(jm.cfg)(jlogits, paddle.to_tensor(labels))
    np.testing.assert_allclose(plain.item(), float(theirs.numpy()),
                               **LOGIT_TOL)


@pytest.mark.parametrize("name", ["tiny", "rep5"])
def test_cached_forward_matches_the_full_forward(models, name):
    """Dense ERNIE decodes over Llama's page-pool cache: a 7-token prompt
    then 4 one-token steps give the full forward's logits."""
    _, tm, _ = models[name]
    ids, _ = _batch(5, b=2, s=11)
    ids = torch.from_numpy(ids)
    with torch.no_grad():
        full = tm(ids)
        caches = tm.init_cache(2, 16)
        got, caches = tm(ids[:, :7], caches=caches, cache_pos=0)
        steps = [got]
        for t in range(7, 11):
            out, caches = tm(ids[:, t:t + 1], caches=caches, cache_pos=t)
            steps.append(out)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(),
                               **LOGIT_TOL)


def test_moe_refuses_the_cache_and_the_engine(models):
    """The MoE model has no ``init_cache``, a cached call raises JAX's
    ``ValueError``, ``ServingModel`` (so ``LLMEngine``) raises ``TypeError``
    naming the first MoE layer, and ``generate`` takes the host loop."""
    jm, tm, _ = models["rep5_moe"]
    assert tm.init_cache is None and jm.init_cache is None
    with pytest.raises(ValueError) as ours:
        tm(torch.zeros(1, 1, dtype=torch.long), caches=[None], cache_pos=0)
    with pytest.raises(ValueError) as theirs:
        jm(paddle.to_tensor(np.zeros((1, 1), np.int64)), caches=[None],
           cache_pos=0)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(TypeError, match=r"layers\.1\.mlp"):
        ServingModel(tm)
    with pytest.raises(TypeError, match=r"layers\.1\.mlp"):
        LLMEngine(tm, ServingConfig(num_pages=8), device="cpu")
    ids, _ = _batch(6, b=2, s=5)
    out = tm.generate(torch.from_numpy(ids), max_new_tokens=3)
    with torch.no_grad():
        first = tm(torch.from_numpy(ids))[:, -1].argmax(-1)
    assert tuple(out.shape) == (2, 8)
    assert torch.equal(out[:, 5], first)


def test_config_matches_jax():
    """Fields and defaults, ``head_dim``, ``as_llama`` / ``as_moe`` and the
    ``__post_init__`` error word for word; the full-size dense and MoE
    models' parameter counts (built on ``meta``) and FLOPs a token."""
    ours, theirs = ErnieConfig(), je.ErnieConfig()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.head_dim == theirs.head_dim == 128
    assert dataclasses.asdict(ours.as_llama()) == \
        dataclasses.asdict(theirs.as_llama())
    kw = dict(num_experts=64)
    mo, mt = ErnieConfig(**kw).as_moe(), je.ErnieConfig(**kw).as_moe()
    assert {k: v for k, v in dataclasses.asdict(mo).items()} == \
        {k: v for k, v in dataclasses.asdict(mt).items()}
    bad = dict(num_experts=2, num_experts_per_tok=4)
    with pytest.raises(ValueError) as a:
        ErnieConfig(**bad)
    with pytest.raises(ValueError) as b:
        je.ErnieConfig(**bad)
    assert str(a.value) == str(b.value)
    dense = Ernie(ErnieConfig(), device="meta", seed=None)
    assert dense.lm_head is None and dense.num_params() == 3_347_724_800
    moe = Ernie(ErnieConfig(num_experts=64), device="meta", seed=None)
    assert moe.num_params() == 20_161_806_400


@pytest.mark.parametrize("name", ["tiny", "rep5_moe"])
def test_sizes_and_flops_match_jax(models, name):
    jm, tm, _ = models[name]
    assert tm.num_params() == jm.num_params()
    assert tm.flops_per_token(16) == pytest.approx(jm.flops_per_token(16))


def test_engine_over_tiny_dense_ernie_matches_the_full_forward(models):
    """``LLMEngine`` (default ``ServingConfig``: monolithic prefill, fused
    epilogues, prefix cache) over the rep-5 dense model: each request's
    greedy tokens are the argmax of the port's plain full forward over its
    growing sequence."""
    _, tm, _ = models["rep5"]
    eng = LLMEngine(tm, ServingConfig(num_pages=24, max_batch=2,
                                      max_new_tokens=5), device="cpu")
    prompts = [list(range(3, 10)), [7, 1, 2], list(range(20, 33))]
    try:
        reqs = [eng.submit(p) for p in prompts]
        outs = [r.result(timeout=120) for r in reqs]
    finally:
        summary = eng.shutdown()
    assert summary["pages_leaked"] == 0 and eng.pool.lost() == 0
    for prompt, out in zip(prompts, outs):
        seq = list(prompt)
        with torch.no_grad():
            for _ in range(5):
                logits = tm(torch.tensor([seq]), plain=True)
                seq.append(int(logits[0, -1].argmax()))
        assert list(out) == seq[len(prompt):], (prompt, out, seq)


@pytest.mark.parametrize("rep", [3, 5, 6, 12])
def test_reference_mmha_at_any_rep_matches_jax(rep):
    """The plain decode attention (the kernel's reference on the card) at
    query-group sizes that are not powers of two, over the paged pool and
    the contiguous cache, against JAX's ``mmha_decode`` in interpret mode
    (its query group padded to a multiple of 8)."""
    rng = np.random.default_rng(rep)
    b, h_kv, d, ps, pages = 3, 2, 64, 16, 4
    lengths = [1, 29, 64]
    tables, pos, n_pages = mmha.paged_tables(lengths, ps, pages, seed=rep)
    q = rng.standard_normal((b, 1, h_kv * rep, d)).astype(np.float32)
    kp = rng.standard_normal((n_pages, h_kv, ps, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, h_kv, ps, d)).astype(np.float32)
    got = mmha.mmha_decode(torch.from_numpy(q), torch.from_numpy(kp),
                           torch.from_numpy(vp), tables, pos).numpy()
    kc = mmha.gather_pages(torch.from_numpy(kp), tables)
    vc = mmha.gather_pages(torch.from_numpy(vp), tables)
    want = np.asarray(mmha_pallas.mmha_decode(
        jnp.asarray(q), jnp.asarray(kc.numpy()), jnp.asarray(vc.numpy()),
        jnp.asarray(pos.numpy()), interpret=True))
    np.testing.assert_allclose(got, want, **MMHA_TOL)
    cont = mmha.mmha_decode_contiguous(torch.from_numpy(q), kc, vc, pos)
    np.testing.assert_allclose(cont.numpy(), want, **MMHA_TOL)
    blk, n_sub = mmha.rep_block(rep)
    assert blk >= min(rep, 8) and blk * n_sub >= rep
