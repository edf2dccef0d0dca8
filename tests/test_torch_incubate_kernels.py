"""The incubate kernels of paddle_tpu_torch against the JAX package's Pallas
kernels, on the CPU.

The JAX kernels run in interpret mode (``force_interpret(True)``, restored
in ``finally``, as ``tests/test_kernels_fused.py`` runs them); the port
runs its plain versions, which a CPU tensor takes. Inputs are made with
numpy from a seed and handed to both. Tolerances, as the largest absolute
error over the largest reference magnitude: f32 1e-5 (the same f32
arithmetic, summed in another order); bf16 2**-7, one bf16 ulp (the same
f32 arithmetic rounded once, a value near a rounding boundary may land on
the other side). Dropout masks are held exactly. No kernel may launch on
the CPU.

- row 18, masked softmax: masks ``[B,1,Sq,Sk]``, ``[1,1,Sq,Sk]`` and
  ``[B,1,1,Sk]``, a mask that requires grad (its reduced gradient), and
  the causal variant with ``Sq == Sk`` and ``Sq < Sk`` (the top-left
  triangle); forward and vjp;
- row 19, bias-dropout-residual layer norm: an explicit mask, maskless,
  and ``p = 1`` (a zero mask); ``(y, h)`` and the vjp with a cotangent on
  ``h`` too, in f32 and bf16 (bf16 pins the statistics recomputed from the
  saved bf16 ``h``: the f32 sums of dgamma would leave JAX's otherwise);
- row 20, dropout-add: the same seed drops the same positions as the JAX
  kernel and ``reference_dropout_add`` at a shape that is no multiple of
  any block; forward and vjp;
- row 21, the weight-gradient accumulation into f32 and bf16, ``M`` not a
  multiple of the JAX kernel's 512-row step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.kernels import _common as kern
from paddle_tpu.ops.kernels import bias_dropout_ln_pallas as jbdl
from paddle_tpu.ops.kernels import dropout_add_pallas as jda
from paddle_tpu.ops.kernels import linear_grad_add_pallas as jlga
from paddle_tpu.ops.kernels import softmax_mask_pallas as jsm
from paddle_tpu_torch.ops.kernels import WRAPPERS
from paddle_tpu_torch.ops.kernels import bias_dropout_ln as bdl
from paddle_tpu_torch.ops.kernels import dropout_add as da
from paddle_tpu_torch.ops.kernels import linear_grad_add as lga
from paddle_tpu_torch.ops.kernels import softmax_mask as sm

TOL = {np.float32: 1e-5, "bfloat16": 2.0 ** -7}
DTYPES = {np.float32: (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    for w in WRAPPERS.values():
        w.launches = 0
    yield
    assert all(w.launches == 0 for w in WRAPPERS.values())


@pytest.fixture
def interpret():
    kern.force_interpret(True)
    try:
        yield
    finally:
        kern.force_interpret(False)


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, ref, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else _np(got)
    ref = ref.float().numpy() if isinstance(ref, torch.Tensor) else _np(ref)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    assert err <= tol * float(np.abs(ref).max()), err


def _both(arr, dtype):
    """The same numpy values as a JAX array and a torch tensor of dtype."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(arr, jd), torch.tensor(arr).to(td)


# -- row 18 -------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("mask_shape", [(2, 1, 8, 16), (1, 1, 8, 16),
                                        (2, 1, 1, 16)])
def test_softmax_mask_matches_jax_kernel(interpret, dtype, mask_shape):
    rng = np.random.default_rng(18)
    x = (rng.standard_normal((2, 3, 8, 16)) * 3).astype(np.float32)
    m = np.where(rng.random(mask_shape) < 0.2, -1e4,
                 rng.standard_normal(mask_shape)).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    (jx, tx), (jm, tm), (jdy, tdy) = (_both(a, dtype) for a in (x, m, dy))
    y_j, vjp = jax.vjp(lambda a: jsm.softmax_mask_fused(a, jm, True), jx)
    (dx_j,) = vjp(jdy)
    tx.requires_grad_()
    y_t = sm.SoftmaxMaskFunction.apply(tx, tm, False)
    y_t.backward(tdy)
    _close(y_t.detach(), y_j, TOL[dtype])
    _close(tx.grad, dx_j, TOL[dtype])


def test_softmax_mask_gradient_of_a_trainable_mask(interpret):
    """A mask that requires grad gets dx summed onto its broadcast shape,
    as the JAX custom_vjp returns it."""
    rng = np.random.default_rng(19)
    x = rng.standard_normal((2, 3, 8, 16)).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    for mask_shape in ((2, 1, 8, 16), (1, 1, 1, 16)):
        m = rng.standard_normal(mask_shape).astype(np.float32)
        _, vjp = jax.vjp(lambda a, b: jsm.softmax_mask_fused(a, b, True),
                         jnp.asarray(x), jnp.asarray(m))
        dx_j, dm_j = vjp(jnp.asarray(dy))
        tx = torch.tensor(x, requires_grad=True)
        tm = torch.tensor(m, requires_grad=True)
        sm.SoftmaxMaskFunction.apply(tx, tm, False).backward(torch.tensor(dy))
        _close(tx.grad, dx_j, 1e-5)
        assert tm.grad.shape == mask_shape
        _close(tm.grad, dm_j, 1e-5)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("sq,sk", [(16, 16), (8, 24)])
def test_softmax_mask_tri_matches_jax_kernel(interpret, dtype, sq, sk):
    rng = np.random.default_rng(20)
    x = (rng.standard_normal((2, 3, sq, sk)) * 3).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    (jx, tx), (jdy, tdy) = _both(x, dtype), _both(dy, dtype)
    y_j, vjp = jax.vjp(lambda a: jsm.softmax_mask_tri(a, True), jx)
    (dx_j,) = vjp(jdy)
    tx.requires_grad_()
    y_t = sm.SoftmaxMaskTriFunction.apply(tx, False)
    y_t.backward(tdy)
    _close(y_t.detach(), y_j, TOL[dtype])
    _close(tx.grad, dx_j, TOL[dtype])
    # the top-left triangle: row q sees columns 0..q, also when sq < sk
    above = np.arange(sk)[None, :] > np.arange(sq)[:, None]
    assert not y_t.detach()[..., torch.tensor(above)].any()
    _close(y_t.detach(), jsm.reference_softmax_mask(jx), TOL[dtype])


# -- row 19 -------------------------------------------------------------------

def _bdl_inputs(rng, p):
    shape, hd = (3, 17, 64), 64
    x = rng.standard_normal(shape).astype(np.float32)
    res = rng.standard_normal(shape).astype(np.float32)
    b = (rng.standard_normal(hd) * 0.1).astype(np.float32)
    g = (1.0 + rng.standard_normal(hd) * 0.1).astype(np.float32)
    be = (rng.standard_normal(hd) * 0.1).astype(np.float32)
    if p is None:
        mask = None
    elif p >= 1.0:
        mask = np.zeros(shape, np.float32)
    else:
        mask = ((rng.random(shape) >= p) / (1.0 - p)).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    dh = rng.standard_normal(shape).astype(np.float32)
    return x, res, b, g, be, mask, dy, dh


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("p", [0.3, None, 1.0], ids=["mask", "maskless",
                                                     "p1"])
def test_bias_dropout_ln_matches_jax_kernel(interpret, dtype, p):
    rng = np.random.default_rng(21)
    x, res, b, g, be, mask, dy, dh = _bdl_inputs(rng, p)
    (jx, tx), (jr, tr), (jdy, tdy), (jdh, tdh) = (
        _both(a, dtype) for a in (x, res, dy, dh))
    vec_j = [jnp.asarray(a) for a in (b, g, be)]
    vec_t = [torch.tensor(a, requires_grad=True) for a in (b, g, be)]
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.tensor(mask)

    def f(a, bb, r, gg, bbe):
        return jbdl.bias_dropout_ln(a, bb, r, jm, gg, bbe, 1e-5, True)
    (y_j, h_j), vjp = jax.vjp(f, jx, vec_j[0], jr, vec_j[1], vec_j[2])
    dx_j, db_j, dres_j, dg_j, dbe_j = vjp((jdy, jdh))

    tx.requires_grad_()
    tr.requires_grad_()
    y_t, h_t = bdl.BiasDropoutLNFunction.apply(
        tx, vec_t[0], tr, tm, vec_t[1], vec_t[2], 1e-5, False)
    torch.autograd.backward((y_t, h_t), (tdy, tdh))
    tol = TOL[dtype]
    _close(y_t.detach(), y_j, tol)
    _close(h_t.detach(), h_j, tol)
    _close(tx.grad, dx_j, tol)
    _close(tr.grad, dres_j, tol)
    for got, ref in zip(vec_t, (db_j, dg_j, dbe_j)):
        _close(got.grad, ref, 1e-5)


def test_bias_dropout_ln_plain_matches_jax_reference():
    """The plain forward is JAX's reference composite (f32)."""
    rng = np.random.default_rng(22)
    x, res, b, g, be, mask, _, _ = _bdl_inputs(rng, 0.5)
    y_r, h_r = jbdl.reference_bias_dropout_ln(
        *(jnp.asarray(a) for a in (x, b, res, mask, g, be)), 1e-5)
    y_t, h_t = bdl.bias_dropout_ln_plain(
        *(torch.tensor(a) for a in (x, b, res, mask, g, be)), 1e-5)
    _close(y_t, y_r, 1e-5)
    _close(h_t, h_r, 1e-5)


# -- row 20 -------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("seed,p", [(1234, 0.1), (2 ** 31 - 2, 0.5),
                                    (0, 0.9)])
def test_dropout_add_drops_what_jax_drops(interpret, dtype, seed, p):
    rng = np.random.default_rng(23)
    shape = (3, 37, 20)           # 2220 elements: no multiple of a block
    x = (np.abs(rng.standard_normal(shape)) + 1.0).astype(np.float32)
    res = rng.standard_normal(shape).astype(np.float32)
    dy = (np.abs(rng.standard_normal(shape)) + 1.0).astype(np.float32)
    (jx, tx), (jr, tr), (jdy, tdy) = (_both(a, dtype) for a in (x, res, dy))
    jseed = jnp.asarray(seed, jnp.int32)
    y_j, vjp = jax.vjp(lambda a, r: jda.dropout_add(a, r, jseed, p, True),
                       jx, jr)
    dx_j, dres_j = vjp(jdy)
    y_ref = jda.reference_dropout_add(jx, jr, seed, p)
    tx.requires_grad_()
    tr.requires_grad_()
    y_t = da.DropoutAddFunction.apply(tx, tr, seed, p, False)
    y_t.backward(tdy)
    # the dropped positions, exactly: x and dy are bounded away from 0, so
    # the dropped elements are those where y == residual and dx == 0
    dropped_j = _np(y_j) == _np(jr)
    assert np.array_equal(_np(y_ref) == _np(jr), dropped_j)
    assert np.array_equal(y_t.detach().float().numpy()
                          == tr.detach().float().numpy(), dropped_j)
    assert np.array_equal(tx.grad.float().numpy() == 0, _np(dx_j) == 0)
    assert np.array_equal(_np(dx_j) == 0, dropped_j)
    keep = da.keep_mask(1, x.size, seed, p).reshape(shape).numpy()
    assert np.array_equal(~keep, dropped_j)
    tol = TOL[dtype]
    _close(y_t.detach(), y_j, tol)
    _close(tx.grad, dx_j, tol)
    _close(tr.grad, dres_j, tol)


# -- row 21 -------------------------------------------------------------------

@pytest.mark.parametrize("acc_dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(600, 64, 48), (37, 24, 16)])
def test_linear_grad_add_matches_jax_kernel(interpret, acc_dtype, m, k, n):
    rng = np.random.default_rng(24)
    x = rng.standard_normal((m, k)).astype(np.float32)
    dy = rng.standard_normal((m, n)).astype(np.float32)
    acc = (rng.standard_normal((k, n)) * 4).astype(np.float32)
    (jx, tx), (jdy, tdy) = _both(x, "bfloat16"), _both(dy, "bfloat16")
    jacc, tacc = _both(acc, acc_dtype)
    want = jlga.linear_grad_acc(jx, jdy, jacc, interpret=True)
    got = lga.linear_grad_add(tx, tdy, tacc)
    assert got is tacc                      # in place
    assert got.dtype == DTYPES[acc_dtype][1]
    _close(got, want, TOL[acc_dtype])
    _close(got, jlga.reference_grad_acc(jx, jdy, jacc), TOL[acc_dtype])
