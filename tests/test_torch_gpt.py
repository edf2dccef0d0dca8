"""paddle_tpu_torch GPT-2 against the JAX package's ``models/gpt.py``, on the
CPU.

A JAX ``gpt2_tiny`` (2 layers, hidden 128, 4 heads, vocab 1024, f32) is
built from a seed and carried across with ``gpt_from_jax_state``. The JAX
side runs with its Pallas kernels in interpret mode, on its fused trunk
(``use_fused_blocks`` 1: every junction through the block-epilogue forward
and backward kernels) or its layer loop (0); the port runs the same trunk
(``GPT.fused_blocks``) through the plain versions of its kernels (no
launch is counted on the CPU). Tolerances: 1e-5 on logits and the loss,
1e-4 on every gradient (the same f32 math, summed in another order), and
5e-3 relative on each loss of a 20-step AdamW curve over fresh batches:
Adam's first steps move an entry by up to the learning rate whatever its
size, so entries within a few f32 roundings of zero (``|g|`` near
``epsilon``) step apart in the two packages, and the curves drift apart
over the steps by more than one step's rounding.
"""

import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import gpt2_tiny as jax_gpt2_tiny
from paddle_tpu.ops.kernels import _common as jax_kern
from paddle_tpu.ops.kernels import block_fused_pallas
from paddle_tpu_torch.models import (GPT, GPTConfig, gpt2_small, gpt2_tiny,
                                     gpt_from_jax_state)
from paddle_tpu_torch.ops.kernels import WRAPPERS

LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
CURVE_RTOL = 5e-3
LINEAR = ("qkv.weight", "proj.weight", "fc.weight", "lm_head.weight")
VOCAB = 1024


@pytest.fixture(params=[True, False], ids=["fused", "loop"])
def jax_trunk(request):
    """The JAX package with its Pallas kernels in interpret mode and the
    fused trunk or the layer loop; both restored after the test."""
    flags = paddle.get_flags(["use_fused_blocks"])
    jax_kern.force_interpret(True)
    paddle.set_flags({"use_fused_blocks": int(request.param)})
    try:
        yield request.param
    finally:
        paddle.set_flags(flags)
        jax_kern.force_interpret(False)


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    for w in WRAPPERS.values():
        w.launches = 0
    yield
    assert all(w.launches == 0 for w in WRAPPERS.values())


def _jax_state(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _models(seed=7, fused=False):
    paddle.seed(seed)
    jm = jax_gpt2_tiny()
    tm = gpt_from_jax_state(_jax_state(jm),
                            GPTConfig(**dataclasses.asdict(jm.cfg)),
                            device="cpu")
    tm.fused_blocks = fused
    assert jm._use_fused_blocks() == fused
    return jm, tm


def _as_port(name, arr):
    return arr.T if name.endswith(LINEAR) else arr


def _batch(seed, b=2, s=16, mod=VOCAB):
    """Counting sequences modulo ``mod`` from random starts (``t + 1``
    follows ``t``), fresh on every call."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, mod, (b, 1))
    toks = (start + np.arange(s + 1)[None]) % mod
    return toks[:, :-1].astype(np.int64), toks[:, 1:].astype(np.int64)


def test_gpt_from_jax_state_round_trips():
    """Every key of the JAX state arrives, linear weights transposed and
    everything else as it was; transposing back gives the JAX state."""
    paddle.seed(1)
    jm = jax_gpt2_tiny()
    state = _jax_state(jm)
    tm = gpt_from_jax_state(state, GPTConfig(**dataclasses.asdict(jm.cfg)),
                            device="cpu")
    got = {k: v.numpy() for k, v in tm.state_dict().items()}
    assert set(got) == set(state)
    for name, arr in state.items():
        np.testing.assert_array_equal(_as_port(name, got[name]), arr,
                                      err_msg=name)
    assert tm.lm_head is None
    bad = dict(state)
    bad.pop("ln_f.bias")
    with pytest.raises(KeyError, match="ln_f.bias"):
        gpt_from_jax_state(bad, tm.cfg, device="cpu")


def test_qkv_output_keeps_jax_split():
    """The port's ``attn.qkv`` output, reshaped ``[B, S, 3, H, D]``, is
    the JAX model's: the same q, k and v heads."""
    jm, tm = _models()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    want = np.asarray(jm.blocks[0].attn.qkv(paddle.to_tensor(x)).numpy())
    with torch.no_grad():
        got = tm.blocks[0].attn.qkv(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got.reshape(2, 5, 3, 4, 32),
                               want.reshape(2, 5, 3, 4, 32), **LOGIT_TOL)


def test_forward_logits_match_jax(jax_trunk):
    jm, tm = _models(fused=jax_trunk)
    ids, _ = _batch(0)
    want = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)


def test_loss_and_gradients_match_jax(jax_trunk, monkeypatch):
    """One batch, labels partly ignored: the loss and every parameter's
    gradient (the tied ``wte`` takes both the embedding's and the head's).
    The JAX fused trunk's backward reaches the block-epilogue backward
    kernel."""
    reached = []
    real_bwd = block_fused_pallas._bwd

    def counted(*a, **kw):
        reached.append(1)
        return real_bwd(*a, **kw)
    monkeypatch.setattr(block_fused_pallas, "_bwd", counted)
    jm, tm = _models(fused=jax_trunk)
    ids, labels = _batch(1)
    labels[:, :3] = -100
    _, jloss = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    jloss.backward()
    _, loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss.numpy()), **LOGIT_TOL)
    got = dict(tm.named_parameters())
    want = {n: _as_port(n, np.asarray(p.grad.numpy()))
            for n, p in jm.named_parameters()}
    assert set(got) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), g, **GRAD_TOL,
                                   err_msg=name)
    assert bool(reached) == jax_trunk


def test_dropout_in_training_and_caches_raise():
    cfg = GPTConfig(vocab_size=64, max_position_embeddings=16,
                    hidden_size=32, num_layers=1, num_heads=2, dropout=0.1)
    model = GPT(cfg, device="cpu")
    ids = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="dropout"):
        model(ids)
    model.eval()
    full = model(ids)
    assert full.shape == (1, 4, 64)
    # caches and generate are ported: the cached forward gives the
    # whole-sequence logits, and generate runs
    logits, caches = model(ids, caches=model.init_cache(1, 4), cache_pos=0)
    torch.testing.assert_close(logits, full, rtol=1e-5, atol=1e-5)
    assert len(caches) == 1
    assert tuple(model.generate(ids, max_new_tokens=3).shape) == (1, 7)


def test_sizes_and_flops_match_jax():
    """``num_params`` and ``flops_per_token`` as the JAX model counts
    them; ``gpt2_small`` has GPT-2 small's 124M parameters (built on the
    meta device: no memory)."""
    jm, tm = _models()
    for non_emb in (True, False):
        assert tm.num_params(non_emb) == jm.num_params(non_emb)
    assert tm.flops_per_token(16) == pytest.approx(jm.flops_per_token(16))
    small = gpt2_small(device="meta", seed=None)
    assert small.num_params(non_embedding=False) == 124_475_904
    assert len(small.blocks) == 12 and small.cfg.vocab_size == 50304
    assert gpt2_tiny(device="cpu").cfg.hidden_size == 128
