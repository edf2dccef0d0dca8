"""The LAMB kernel's plain version against the JAX package's
``lamb_pallas.lamb_update`` (the Pallas kernel in interpret mode) and its
``reference_lamb``, and GPT-2 tiny trained with Lamb, a warm-up + cosine
schedule and ``ParallelCrossEntropy`` against the JAX package, on the CPU.

The plain version follows the TPU kernel's order of operations (the
inverse bias corrections multiplied in), so it agrees with the
interpret-mode kernel to f32 rounding of the two norms' sums: 1e-6
relative on the weights, the moments and the trust ratio. Against
``reference_lamb``, which divides by the bias corrections, the same 1e-6.
A bf16 result is held to one bf16 ulp. Inputs are made with numpy from a
seed, at sizes that are not a multiple of 128 nor of a 1024-thread block,
and the all-zero case (trust 1). The GPT-2 curve: 20 steps over fresh
batches, each loss within 5e-3 relative of JAX's (the rule of
``test_torch_gpt.py``'s AdamW curve).
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.kernels import lamb_pallas
from paddle_tpu_torch.ops.kernels import WRAPPERS, adamw, lamb

TOL = dict(rtol=1e-6, atol=1e-7)
HYPER = dict(beta1=0.9, beta2=0.999, eps=1e-6)
CURVE_RTOL = 5e-3


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    for w in WRAPPERS.values():
        w.launches = 0
    yield
    assert all(w.launches == 0 for w in WRAPPERS.values())


def _state(shape, seed, zero=False):
    rng = np.random.default_rng(seed)
    if zero:
        return [np.zeros(shape, np.float32) for _ in range(4)]
    w = rng.standard_normal(shape).astype(np.float32) * 0.3
    g = rng.standard_normal(shape).astype(np.float32) * 0.01
    m = rng.standard_normal(shape).astype(np.float32) * 1e-3
    v = rng.uniform(0, 1e-4, shape).astype(np.float32)
    return [w, g, m, v]


def _port(w, g, m, v, lr, step, wd, out_dtype, emit_w32, g_bf16):
    """The port's plain LAMB on copies; returns (w32' or None, m', v',
    p_out, trust)."""
    tg = torch.from_numpy(g)
    if g_bf16:
        tg = tg.to(torch.bfloat16)
    tm, tv = torch.from_numpy(m.copy()), torch.from_numpy(v.copy())
    scal = adamw.adamw_scalars(torch.tensor(lr), torch.tensor(float(step)),
                               HYPER["beta1"], HYPER["beta2"])
    master = torch.from_numpy(w.copy()) if emit_w32 else None
    param = torch.from_numpy(w.copy()).to(out_dtype)
    trust = lamb.lamb_update_plain(param, tg, tm, tv, scal, wd=wd, **HYPER,
                                   master=master)
    return (None if master is None else master.numpy(), tm.numpy(),
            tv.numpy(), param, float(trust))


@pytest.mark.parametrize("shape", [(300, 70), (7,), (1000,), (129, 128),
                                   (3, 5, 67)])
@pytest.mark.parametrize("out_dtype,emit_w32", [
    (torch.float32, False), (torch.float32, True), (torch.bfloat16, True),
    (torch.bfloat16, False)])
@pytest.mark.parametrize("g_bf16", [False, True])
def test_plain_lamb_matches_interpret_kernel(shape, out_dtype, emit_w32,
                                             g_bf16):
    w, g, m, v = _state(shape, seed=sum(shape))
    if out_dtype == torch.bfloat16 and not emit_w32:
        # no master: the port reads the bf16 parameter itself
        w = torch.from_numpy(w).to(torch.bfloat16).float().numpy()
    if g_bf16:
        g = torch.from_numpy(g).to(torch.bfloat16).float().numpy()
    lr, step, wd = 2e-3, 3, 0.01
    jw, jm, jv, jp, jt = lamb_pallas.lamb_update(
        jnp.asarray(w), jnp.asarray(g), jnp.asarray(m), jnp.asarray(v),
        jnp.float32(lr), jnp.float32(step), wd=wd, **HYPER,
        out_dtype=jnp.bfloat16 if out_dtype == torch.bfloat16
        else jnp.float32, interpret=True, emit_w32=emit_w32)
    tw, tm, tv, tp, tt = _port(w, g, m, v, lr, step, wd, out_dtype,
                               emit_w32, g_bf16)
    np.testing.assert_allclose(tm, np.asarray(jm), **TOL)
    np.testing.assert_allclose(tv, np.asarray(jv), **TOL)
    np.testing.assert_allclose(tt, float(jt), rtol=1e-6)
    if emit_w32:
        np.testing.assert_allclose(tw, np.asarray(jw), **TOL)
    else:
        assert jw is None
    want = np.asarray(jp.astype(jnp.float32))
    got = tp.float().numpy()
    if out_dtype == torch.bfloat16:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-7)
    else:
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("shape", [(300, 70), (1000,), (3, 5, 67)])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_plain_lamb_matches_reference(shape, wd):
    w, g, m, v = _state(shape, seed=7)
    jw, jm, jv, jt = lamb_pallas.reference_lamb(
        jnp.asarray(w), jnp.asarray(g), jnp.asarray(m), jnp.asarray(v),
        jnp.float32(1e-3), jnp.float32(5), wd=wd, **HYPER)
    tw, tm, tv, _, tt = _port(w, g, m, v, 1e-3, 5, wd, torch.float32, True,
                              False)
    for a, b in ((tw, jw), (tm, jm), (tv, jv)):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)
    np.testing.assert_allclose(tt, float(jt), rtol=1e-6)


@pytest.mark.parametrize("zero_grad", [False, True])
def test_zero_weights_take_trust_one(zero_grad):
    """A zero tensor (a bias at initialisation) has ||w|| = 0: trust is 1,
    as in the JAX kernel, and the step is lr * r; with a zero gradient as
    well, nothing moves."""
    shape = (768,)
    w, g, m, v = _state(shape, seed=1, zero=True)
    if not zero_grad:
        g = _state(shape, seed=2)[1]
    _, jm, jv, jp, jt = lamb_pallas.lamb_update(
        jnp.asarray(w), jnp.asarray(g), jnp.asarray(m), jnp.asarray(v),
        jnp.float32(1e-2), jnp.float32(1), wd=0.01, **HYPER,
        out_dtype=jnp.float32, interpret=True, emit_w32=False)
    _, tm, tv, tp, tt = _port(w, g, m, v, 1e-2, 1, 0.01, torch.float32,
                              False, False)
    assert tt == float(jt) == 1.0
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
    if zero_grad:
        assert not tp.any()
    else:
        # the first step moves each entry by about lr (Adam's |r| ~ 1)
        assert 0.5e-2 < float(tp.abs().mean()) < 1.5e-2


def test_lamb_wrapper_counts_nothing_on_cpu_and_checks_operands():
    w = torch.zeros(10)
    m, v = torch.zeros(10), torch.zeros(10)
    scal = adamw.adamw_scalars(torch.tensor(1e-3), torch.tensor(1.0), 0.9,
                               0.999)
    lamb.lamb_update(w, torch.ones(10), m, v, scal, wd=0.0, **HYPER)
    assert lamb.lamb_update.launches == 0
    with pytest.raises(ValueError):
        lamb.lamb_update(w, torch.ones(11), m, v, scal, wd=0.0, **HYPER)
    with pytest.raises(TypeError):
        lamb.lamb_update(w, torch.ones(10), m.double(), v, scal, wd=0.0,
                         **HYPER)


def _batch(seed, b=4, s=16, mod=32):
    rng = np.random.default_rng(seed)
    start = rng.integers(0, mod, (b, 1))
    toks = (start + np.arange(s + 1)[None]) % mod
    return toks[:, :-1].astype(np.int64), toks[:, 1:].astype(np.int64)


def _schedule(m, peak):
    return m.LinearWarmup(m.CosineAnnealingDecay(peak, T_max=8),
                          warmup_steps=2, start_lr=0.0, end_lr=peak)
