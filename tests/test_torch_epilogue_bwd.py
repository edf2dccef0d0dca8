"""paddle_tpu_torch block-epilogue backward against the JAX package, on the
CPU.

The seven ``(act, norm, p, bias)`` cases of ``tests/test_block_fused.py``
build the same numpy inputs (x, residual, weight, bias; hidden 128, rows
3 x 17) and a loss that uses both outputs, ``sum(y**2) + sum(sin(h))``.
``jax.grad`` runs through ``block_fused_pallas.fused_epilogue`` in
interpret mode (reaching the backward kernel ``_bwd``) and through
``reference_fused_epilogue``; the port's ``BlockEpilogueFunction`` runs its
plain backward on the CPU. Gradients of x, residual, weight and bias are
held within the JAX test's own tolerance (``atol=3e-4, rtol=2e-4``, f32:
the same arithmetic, summed in another order). No kernel may launch on the
CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.kernels import block_fused_pallas as bf
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops.kernels import WRAPPERS
from paddle_tpu_torch.ops.kernels import block_epilogue as be

TOL = dict(atol=3e-4, rtol=2e-4)
SEED = 42
CASES = [
    (None, "rms", 0.0, False),
    (None, "rms", 0.3, False),
    (None, "layer", 0.3, True),
    ("gelu", "layer", 0.2, True),
    ("gelu", "rms", 0.0, False),
    ("swiglu", "rms", 0.4, False),
    ("swiglu", "layer", 0.0, True),
]


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    for w in WRAPPERS.values():
        w.launches = 0
    yield
    assert all(w.launches == 0 for w in WRAPPERS.values())


def _inputs(act, bias_on, hd=128):
    rng = [np.random.default_rng(i) for i in range(4)]
    xw = 2 * hd if act == "swiglu" else hd
    x = rng[0].standard_normal((3, 17, xw)).astype(np.float32)
    res = rng[1].standard_normal((3, 17, hd)).astype(np.float32)
    w = rng[2].standard_normal(hd).astype(np.float32)
    b = rng[3].standard_normal(hd).astype(np.float32) if bias_on else None
    return x, res, w, b


def _jax_grads(impl, x, res, w, b):
    def loss(x, res, w, *bb):
        y, h = impl(x, res, w, bb[0] if bb else None)
        return jnp.sum(y ** 2) + jnp.sum(jnp.sin(h))
    args = tuple(jnp.asarray(a) for a in (x, res, w, b) if a is not None)
    return jax.grad(loss, argnums=tuple(range(len(args))))(*args)


def _port_grads(x, res, w, b, act, norm, p, plain=False):
    ts = [torch.tensor(a, requires_grad=True)
          for a in (x, res, w, b) if a is not None]
    bias = ts[3] if b is not None else None
    y, h = TF.fused_dropout_add_norm(ts[0], ts[1], ts[2], bias, p=p,
                                     epsilon=1e-5, norm=norm,
                                     activation=act, seed=SEED, plain=plain)
    (y.square().sum() + torch.sin(h).sum()).backward()
    return [t.grad for t in ts]


@pytest.mark.parametrize("act,norm,p,bias_on", CASES)
def test_epilogue_backward_matches_jax_kernel(monkeypatch, act, norm, p,
                                              bias_on):
    """The port's gradients against ``jax.grad`` through the JAX kernel in
    interpret mode (which must reach ``_bwd``) and through the JAX
    composite."""
    reached = []
    real_bwd = bf._bwd

    def counted(*a, **kw):
        reached.append(1)
        return real_bwd(*a, **kw)
    monkeypatch.setattr(bf, "_bwd", counted)
    x, res, w, b = _inputs(act, bias_on)
    kern = _jax_grads(lambda *a: bf.fused_epilogue(
        *a, jnp.int32(SEED), p, 1e-5, act, norm, None, True), x, res, w, b)
    ref = _jax_grads(lambda *a: bf.reference_fused_epilogue(
        *a, jnp.int32(SEED), p, 1e-5, act, norm), x, res, w, b)
    assert reached, "the JAX kernel path did not reach _bwd"
    got = _port_grads(x, res, w, b, act, norm, p)
    assert len(got) == len(kern) == len(ref)
    for name, g, k, r in zip(("x", "residual", "weight", "bias"), got, kern,
                             ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(k), **TOL,
                                   err_msg=f"{name} vs the JAX kernel")
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL,
                                   err_msg=f"{name} vs the JAX composite")


@pytest.mark.parametrize("act,norm,p,bias_on", CASES)
def test_epilogue_backward_matches_torch_autograd(act, norm, p, bias_on):
    """The hand-written backward against torch autograd of the plain
    forward (both f32 inside: 1e-5, the same math in another order)."""
    x, res, w, b = _inputs(act, bias_on, hd=64)
    got = _port_grads(x, res, w, b, act, norm, p)
    ts = [torch.tensor(a, requires_grad=True)
          for a in (x, res, w, b) if a is not None]
    y, h = be.fused_epilogue_plain(ts[0], ts[1], ts[2],
                                   ts[3] if b is not None else None, SEED, p,
                                   1e-5, act, norm)
    want = torch.autograd.grad(y.square().sum() + torch.sin(h).sum(), ts)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_backward_without_residual_cotangent_and_dtypes():
    """Only ``y`` used (``gh`` None), bf16 x with an f32 residual stream:
    dx takes x's dtype, dres and the weight's and bias's grads their own,
    with the plain backward's values on the same saved ``h``."""
    x, res, w, b = _inputs("gelu", True, hd=64)
    xt = torch.tensor(x, dtype=torch.bfloat16, requires_grad=True)
    rt = torch.tensor(res, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    bt = torch.tensor(b, requires_grad=True)
    y, _ = be.BlockEpilogueFunction.apply(xt, rt, wt, bt, SEED, 0.2, 1e-5,
                                          "gelu", "layer", False)
    y.square().sum().backward()
    assert (xt.grad.dtype, rt.grad.dtype, wt.grad.dtype, bt.grad.dtype) == \
        (torch.bfloat16, torch.float32, torch.float32, torch.float32)
    hf = be.fused_epilogue_plain(xt.detach(), rt.detach(), wt.detach(),
                                 bt.detach(), SEED, 0.2, 1e-5, "gelu",
                                 "layer")[1]
    dx, dres, dw, db = be.fused_epilogue_bwd_plain(
        hf, xt.detach(), wt.detach(), 2 * y.detach(), None, SEED, 0.2, 1e-5,
        "gelu", "layer", True)
    torch.testing.assert_close(xt.grad, dx)
    torch.testing.assert_close(rt.grad, dres)
    torch.testing.assert_close(wt.grad, dw)
    torch.testing.assert_close(bt.grad, db)


def test_backward_regenerates_the_forward_mask():
    """With a zero ``gy``, ``dres = gh`` and ``dx`` is zero exactly where
    the forward dropped an element (the same counter-hash bits)."""
    rng = np.random.default_rng(9)
    n, hd, p = 37, 40, 0.3
    h = torch.tensor(rng.standard_normal((n, hd)).astype(np.float32))
    gh = torch.tensor(rng.uniform(1.0, 2.0, (n, hd)).astype(np.float32))
    dx, dres, dw, db = be.fused_epilogue_bwd_plain(
        h, None, torch.ones(hd), torch.zeros(n, hd), gh, 1234, p, 1e-6)
    assert torch.equal(dres, gh) and db is None
    assert torch.equal(dx != 0, be.keep_mask(n, hd, 1234, p))
    _, scale = be.dropout_params(p)
    torch.testing.assert_close(dx[dx != 0], gh[dx != 0] * np.float32(scale))


def test_backward_rejects_what_it_does_not_take():
    h = torch.zeros(4, 16)
    with pytest.raises(ValueError, match="exactly when act"):
        be.fused_epilogue_bwd(h, h, torch.ones(16), h)
    with pytest.raises(ValueError, match="expects x"):
        be.fused_epilogue_bwd(h, h, torch.ones(16), h, act="swiglu")
    with pytest.raises(ValueError, match="rms norm takes no bias"):
        be.fused_epilogue_bwd(h, None, torch.ones(16), h, has_bias=True)
    with pytest.raises(ValueError, match="cotangent"):
        be.fused_epilogue_bwd(h, None, torch.ones(16), h[:2])
    with pytest.raises(ValueError, match="no kernel for device"):
        m = torch.zeros(4, 16, device="meta")
        be.fused_epilogue_bwd(m, None, torch.ones(16, device="meta"), m)
