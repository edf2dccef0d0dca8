"""paddle_tpu_torch Llama training against the JAX package, on the CPU.

A ``llama_tiny`` (2 layers, hidden 64, vocab 512, intermediate 128, f32)
is built in ``paddle_tpu`` from a seed and carried across with
``llama_from_jax_state``. The JAX side runs with its Pallas kernels in
interpret mode, on its unfused trunk (``use_fused_blocks`` 0), where its
training step reaches the RMSNorm, RoPE, flash-attention, SwiGLU and AdamW
kernels, or on its fused trunk (``use_fused_blocks`` 1), where it also
reaches the block-epilogue forward and backward kernels; the port's model
runs the same trunk (``fused_blocks``) through the plain versions of its
kernels on the CPU (no launch is counted). Tolerances: 1e-5 relative on
the loss, 1e-4 on every gradient and on the weights after three AdamW
steps (the same f32 math through two layers, summed in another order).
"""

import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu.ops.kernels import _common as jax_kern
from paddle_tpu.ops.kernels import (adamw_pallas, block_fused_pallas,
                                    flash_attention_pallas, rms_norm_pallas,
                                    rope_pallas, swiglu_pallas)
from paddle_tpu_torch.models import LlamaConfig, llama_from_jax_state
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.ops.kernels import WRAPPERS
from paddle_tpu_torch import optimizer
from paddle_tpu_torch.optimizer import AdamW

LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
LINEAR = ("_proj.weight", "lm_head.weight")
#: the JAX entry points of the Pallas kernels a training step must reach
JAX_KERNELS = ((rms_norm_pallas, "_fused_fwd"), (rms_norm_pallas, "_fused_bwd"),
               (rope_pallas, "_rope_call"),
               (flash_attention_pallas, "flash_attention_forward_lse"),
               (flash_attention_pallas, "flash_attention_backward"),
               (swiglu_pallas, "_fused_fwd"), (swiglu_pallas, "_fused_bwd"),
               (adamw_pallas, "_adamw_call"))
#: the fused trunk: its junctions go through the block epilogue, forward
#: and backward; the first ``input_layernorm`` stays an RMSNorm
JAX_FUSED_KERNELS = JAX_KERNELS + ((block_fused_pallas, "_fwd"),
                                   (block_fused_pallas, "_bwd"))


@pytest.fixture
def jax_train():
    """The JAX package with its Pallas kernels in interpret mode and the
    unfused trunk; both restored after the test."""
    flags = paddle.get_flags(["use_fused_blocks"])
    jax_kern.force_interpret(True)
    paddle.set_flags({"use_fused_blocks": 0})
    try:
        yield
    finally:
        paddle.set_flags(flags)
        jax_kern.force_interpret(False)


@pytest.fixture
def jax_fused():
    """The JAX package with its Pallas kernels in interpret mode and the
    fused trunk; both restored after the test."""
    flags = paddle.get_flags(["use_fused_blocks"])
    jax_kern.force_interpret(True)
    paddle.set_flags({"use_fused_blocks": 1})
    try:
        yield
    finally:
        paddle.set_flags(flags)
        jax_kern.force_interpret(False)


def _count_reached(monkeypatch, kernels):
    """Wrap each JAX kernel entry; returns the dict of those called."""
    reached = {}
    for mod, name in kernels:
        def counted(*a, _fn=getattr(mod, name), _key=(mod.__name__, name),
                    **kw):
            reached[_key] = reached.get(_key, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    return reached


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    for w in WRAPPERS.values():
        w.launches = 0
    yield
    assert all(w.launches == 0 for w in WRAPPERS.values())


def _models(seed=11, fused=False):
    paddle.seed(seed)
    jm = jax_llama_tiny()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    cfg = LlamaConfig(**dataclasses.asdict(jm.cfg))
    tm = llama_from_jax_state(state, cfg, device="cpu")
    tm.fused_blocks = fused
    assert jm._use_fused_blocks() == fused
    return jm, tm


def _batch(seed=0, b=2, s=16, vocab=512, ignore=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s)).astype(np.int64)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int64)
    if ignore:
        labels[:, :ignore] = -100
    return ids, labels


def _as_port(name, arr):
    return arr.T if name.endswith(LINEAR) else arr


def _jax_grads(jm):
    return {n: _as_port(n, np.asarray(p.grad.numpy()))
            for n, p in jm.named_parameters()}


def _jax_weights(jm):
    return {n: _as_port(n, np.asarray(v.numpy()))
            for n, v in jm.state_dict().items()}


@pytest.mark.parametrize("ignore", [0, 5])
def test_loss_and_gradients_match_jax(jax_train, ignore):
    """One (input_ids, labels) batch: the loss and every parameter's
    gradient; ``ignore`` labels of -100 at the start of each row."""
    jm, tm = _models()
    ids, labels = _batch(ignore=ignore)
    _, jloss = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    jloss.backward()
    _, loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss.numpy()), **LOSS_TOL)
    want = _jax_grads(jm)
    got = dict(tm.named_parameters())
    assert set(want) == set(got)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), g, **GRAD_TOL,
                                   err_msg=name)


OPTIMIZERS = {
    # AdamW(1e-3, weight_decay=0.01, global-norm clip 1.0): the kernel path
    "adamw_clip": ("AdamW", dict(weight_decay=0.01, clip=1.0)),
    # Adam with an L2 weight_decay coupled into the gradient
    "adam_l2": ("Adam", dict(weight_decay=0.01)),
    # amsgrad takes the plain path in both packages
    "adamw_amsgrad": ("AdamW", dict(weight_decay=0.01, amsgrad=True)),
}


@pytest.mark.parametrize("kind", sorted(OPTIMIZERS))
def test_three_optimizer_steps_match_jax(jax_train, monkeypatch, kind):
    """Three optimizer steps on a new batch each: the same losses, and the
    same weights after the last step. The JAX steps of the kernel path
    reach every Pallas kernel of it."""
    cls, kw = OPTIMIZERS[kind]
    kw = dict(kw)
    clip = kw.pop("clip", None)
    reached = _count_reached(monkeypatch, JAX_KERNELS)
    jm, tm = _models(seed=5)
    jopt = getattr(paddle.optimizer, cls)(
        1e-3, parameters=jm.parameters(), fuse=False, grad_clip=None
        if clip is None else paddle.nn.ClipGradByGlobalNorm(clip), **kw)
    opt = getattr(optimizer, cls)(
        1e-3, parameters=tm.parameters(),
        grad_clip=None if clip is None else ClipGradByGlobalNorm(clip), **kw)
    for step in range(3):
        ids, labels = _batch(seed=step + 1)
        _, jloss = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
        jloss.backward()
        jopt.step()
        jopt.clear_grad()
        _, loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
        loss.backward()
        opt.step()
        opt.clear_grad()
        np.testing.assert_allclose(loss.item(), float(jloss.numpy()),
                                   **LOSS_TOL)
    got = tm.state_dict()
    for name, w in _jax_weights(jm).items():
        np.testing.assert_allclose(got[name].numpy(), w, **GRAD_TOL,
                                   err_msg=name)
    assert opt.state_dict()["@step"] == 3
    want = {(m.__name__, n) for m, n in JAX_KERNELS}
    if kw.get("amsgrad"):
        want.discard((adamw_pallas.__name__, "_adamw_call"))
    assert set(reached) == want, reached


def test_optimizer_state_dict_resumes_bit_exact():
    """Two steps, a save, a fresh optimizer restored from it, one more
    step: the same weights as three uninterrupted steps."""
    def run(split):
        torch.manual_seed(0)
        lin = torch.nn.Linear(8, 4)
        make = lambda: AdamW(1e-2, parameters=lin.parameters(),  # noqa: E731
                             weight_decay=0.1)
        opt = make()
        for i in range(3):
            if i == split:
                state = opt.state_dict()
                opt = make()
                opt.set_state_dict(state)
            lin(torch.ones(2, 8) * (i + 1)).square().sum().backward()
            opt.step()
            opt.clear_grad()
        return [p.detach().clone() for p in lin.parameters()], opt

    (want, _), (got, opt) = run(None), run(2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert set(opt.state_dict()) == {"param_0_moment1", "param_0_moment2",
                                     "param_1_moment1", "param_1_moment2",
                                     "@step"}


def test_set_lr_and_unported_options():
    """``set_lr`` moves the rate, and raises while a scheduler is bound; a
    learning rate that is neither a number nor a scheduler raises
    ``TypeError``, as JAX's ``float(...)`` does; ``fuse=True`` builds the
    fused step and ``minimize`` steps (both ported since), and only
    ``minimize``'s static-graph branch raises."""
    lin = torch.nn.Linear(4, 4)
    opt = AdamW(1e-3, parameters=lin.parameters())
    opt.set_lr(5e-4)
    assert opt.get_lr() == pytest.approx(5e-4)
    scheduled = AdamW(optimizer.lr.StepDecay(1e-3, step_size=2),
                      parameters=lin.parameters())
    with pytest.raises(RuntimeError):
        scheduled.set_lr(5e-4)
    assert AdamW(1e-3, parameters=lin.parameters(), fuse=True)._fuse
    with pytest.raises(TypeError):
        AdamW(lambda: 1e-3, parameters=lin.parameters())
    with pytest.raises(NotImplementedError):
        opt.minimize(torch.zeros(()), startup_program=object())


@pytest.mark.parametrize("ignore", [0, 5])
def test_fused_blocks_training_matches_jax(jax_fused, monkeypatch, ignore):
    """The fused trunk (the default) trains: one batch's loss and every
    gradient against the JAX fused trunk, whose backward reaches the
    block-epilogue backward kernel ``_bwd``."""
    reached = _count_reached(monkeypatch, JAX_FUSED_KERNELS)
    jm, tm = _models(fused=True)
    ids, labels = _batch(ignore=ignore)
    _, jloss = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    jloss.backward()
    _, loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss.numpy()), **LOSS_TOL)
    got = dict(tm.named_parameters())
    for name, g in _jax_grads(jm).items():
        np.testing.assert_allclose(got[name].grad.numpy(), g, **GRAD_TOL,
                                   err_msg=name)
    assert (block_fused_pallas.__name__, "_bwd") in reached, reached


def test_fused_blocks_three_adamw_steps_match_jax(jax_fused, monkeypatch):
    """Three AdamW steps on the fused trunk, a new batch each: the same
    losses and weights; the JAX steps reach every kernel of the fused
    trunk's path."""
    reached = _count_reached(monkeypatch, JAX_FUSED_KERNELS)
    jm, tm = _models(seed=5, fused=True)
    jopt = paddle.optimizer.AdamW(
        1e-3, parameters=jm.parameters(), weight_decay=0.01, fuse=False,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    opt = AdamW(1e-3, parameters=tm.parameters(), weight_decay=0.01,
                grad_clip=ClipGradByGlobalNorm(1.0))
    for step in range(3):
        ids, labels = _batch(seed=step + 1)
        _, jloss = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
        jloss.backward()
        jopt.step()
        jopt.clear_grad()
        _, loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
        loss.backward()
        opt.step()
        opt.clear_grad()
        np.testing.assert_allclose(loss.item(), float(jloss.numpy()),
                                   **LOSS_TOL)
    got = tm.state_dict()
    for name, w in _jax_weights(jm).items():
        np.testing.assert_allclose(got[name].numpy(), w, **GRAD_TOL,
                                   err_msg=name)
    assert set(reached) == {(m.__name__, n) for m, n in JAX_FUSED_KERNELS}, \
        reached


@pytest.mark.parametrize("cls", ["Adam", "AdamW"])
def test_per_parameter_learning_rate_matches_jax(cls):
    """A parameter whose ``optimize_attr["learning_rate"]`` is 0.5 (as
    ``ParamAttr(learning_rate=0.5)`` sets it) steps at half the rate, in
    the port as in the JAX optimizer; AdamW's ``lr_ratio`` multiplies
    it."""
    rng = np.random.default_rng(4)
    w0 = rng.standard_normal((8, 16)).astype(np.float32)
    b0 = rng.standard_normal(16).astype(np.float32)
    gw = rng.standard_normal((8, 16)).astype(np.float32)
    gb = rng.standard_normal(16).astype(np.float32)
    kw = {"lr_ratio": lambda p: 0.25} if cls == "AdamW" else {}
    jw = paddle.create_parameter([8, 16], "float32")
    jb = paddle.create_parameter([16], "float32")
    jw.set_value(w0)
    jb.set_value(b0)
    jw.optimize_attr = {"learning_rate": 0.5}
    jopt = getattr(paddle.optimizer, cls)(0.1, parameters=[jw, jb],
                                          fuse=False, **kw)
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    tb = torch.nn.Parameter(torch.from_numpy(b0.copy()))
    tw.optimize_attr = {"learning_rate": 0.5}
    opt = getattr(optimizer, cls)(0.1, parameters=[tw, tb], **kw)
    for _ in range(2):
        (paddle.sum(jw * paddle.to_tensor(gw))
         + paddle.sum(jb * paddle.to_tensor(gb))).backward()
        jopt.step()
        jopt.clear_grad()
        ((tw * torch.from_numpy(gw)).sum()
         + (tb * torch.from_numpy(gb)).sum()).backward()
        opt.step()
        opt.clear_grad()
    np.testing.assert_allclose(tw.detach().numpy(), jw.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tb.detach().numpy(), jb.numpy(), rtol=1e-6,
                               atol=1e-6)
    # the scaled parameter moved half as far as the unscaled one would
    step_w = np.abs(tw.detach().numpy() - w0)
    step_b = np.abs(tb.detach().numpy() - b0)
    np.testing.assert_allclose(step_w.mean() / step_b.mean(), 0.5, rtol=0.2)


def test_inference_forward_unchanged(jax_train):
    """Without labels the forward returns the logits, the same through the
    fused trunk, the layer loop and the JAX package, with grad on or off."""
    jm, tm = _models()
    ids, _ = _batch()
    want = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    for fused in (False, True):
        tm.fused_blocks = fused
        with torch.no_grad():
            got = tm(torch.from_numpy(ids))
        np.testing.assert_allclose(got.numpy(), want, **GRAD_TOL)
        np.testing.assert_allclose(tm(torch.from_numpy(ids)).detach().numpy(),
                                   want, **GRAD_TOL)


def test_cross_entropy_options_match_jax():
    """Class weights with the weighted mean, ``sum`` and ``none``, against
    the JAX package's cross_entropy; soft labels too."""
    from paddle_tpu.nn import functional as JF
    from paddle_tpu_torch.nn import functional as TF

    rng = np.random.default_rng(2)
    logits = rng.standard_normal((12, 7)).astype(np.float32)
    labels = rng.integers(0, 7, 12)
    labels[[1, 5]] = -100
    weight = rng.uniform(0.5, 2.0, 7).astype(np.float32)
    for kw in (dict(weight=weight), dict(reduction="sum"),
               dict(reduction="none"), dict(weight=weight, reduction="sum")):
        want = JF.cross_entropy(
            paddle.to_tensor(logits), paddle.to_tensor(labels),
            **{k: paddle.to_tensor(v) if k == "weight" else v
               for k, v in kw.items()})
        got = TF.cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(labels),
            **{k: torch.from_numpy(v) if k == "weight" else v
               for k, v in kw.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                                   rtol=1e-6, atol=1e-6)
    soft = rng.dirichlet(np.ones(7), 12).astype(np.float32)
    want = JF.cross_entropy(paddle.to_tensor(logits), paddle.to_tensor(soft),
                            soft_label=True)
    got = TF.cross_entropy(torch.from_numpy(logits), torch.from_numpy(soft),
                           soft_label=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               rtol=1e-6, atol=1e-6)
