"""paddle_tpu_torch's grouped expert product (``ops/kernels/moe_gemm.py``)
against the JAX package's ``moe_gemm_pallas``, on the CPU.

The port's wrapper takes its plain version for CPU tensors (no launch is
counted). The JAX side runs the Pallas kernel in interpret mode
(``grouped_matmul(..., True)``, as ``tests/test_kernels_fused.py`` runs
it) and its dense ``reference_grouped_matmul``. Inputs come from numpy
seeds and hold non-zero padding rows past the counts. Tolerances: 1e-5
absolute on f32 products of O(1) values summed over at most 64 terms (the
same f32 products summed in another order); in bf16 one bf16 ulp of the
largest reference magnitude (both round one f32 sum once).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.kernels import moe_gemm_pallas
from paddle_tpu_torch.ops.kernels import WRAPPERS, moe_gemm

TOL = dict(rtol=1e-5, atol=1e-5)

# (E, C, H, F, counts): an empty expert, partial ones and a full one;
# C = 10 with F = 384 (C off the JAX kernel's 8-row block, F three lane
# blocks); F = 24 (the JAX kernel's full-width lane block)
CASES = [(4, 10, 64, 384, [0, 3, 10, 7]),
         (4, 16, 32, 64, [16, 5, 0, 9]),
         (3, 9, 16, 24, [9, 1, 4]),
         (2, 1, 8, 8, [1, 0])]


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    WRAPPERS["moe_gemm"].launches = 0
    yield
    assert WRAPPERS["moe_gemm"].launches == 0


def _inputs(e, c, h, f, counts, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e, c, h)).astype(np.float32)
    w = rng.standard_normal((e, h, f)).astype(np.float32)
    g = rng.standard_normal((e, c, f)).astype(np.float32)
    return x, w, np.asarray(counts, np.int32), g


@pytest.mark.parametrize("e,c,h,f,counts", CASES)
def test_forward_matches_jax_kernel_and_reference(e, c, h, f, counts):
    x, w, cnt, _ = _inputs(e, c, h, f, counts)
    want = np.asarray(moe_gemm_pallas.grouped_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(cnt), True))
    ref = np.asarray(moe_gemm_pallas.reference_grouped_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(cnt)))
    tx, tw, tc = map(torch.from_numpy, (x, w, cnt))
    got = moe_gemm.grouped_matmul(tx, tw, tc).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_array_equal(moe_gemm.grouped_matmul_plain(tx, tw, tc),
                                  got)
    for i, n in enumerate(cnt):          # the padding rows are non-zero
        assert np.abs(x[i, n:]).sum() > 0 or n == c
        assert not got[i, n:].any()


@pytest.mark.parametrize("e,c,h,f,counts", CASES)
def test_dx_and_dw_match_jax_custom_vjp(e, c, h, f, counts):
    """The autograd Function's dx (the same product on w^T) and dw (the
    f32 einsum over the cotangent masked past the counts) against
    ``jax.grad`` through the custom_vjp with the kernel in interpret
    mode."""
    x, w, cnt, g = _inputs(e, c, h, f, counts, seed=1)
    jc = jnp.asarray(cnt)
    dx_j, dw_j = jax.grad(lambda a, b: jnp.sum(
        moe_gemm_pallas.grouped_matmul(a, b, jc, True) * g),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    out = moe_gemm.GroupedMatmulFunction.apply(tx, tw, torch.from_numpy(cnt),
                                               False)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(dx_j), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(dw_j), **TOL)


def test_bf16_matches_jax_reference():
    """bf16 operands: one f32 contraction rounded once, as JAX's reference
    computes it, within one bf16 ulp."""
    x, w, cnt, _ = _inputs(3, 20, 64, 128, [20, 0, 11], seed=2)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = np.asarray(moe_gemm_pallas.reference_grouped_matmul(
        xb, wb, jnp.asarray(cnt)).astype(jnp.float32))
    got = moe_gemm.grouped_matmul(
        torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16(),
        torch.from_numpy(np.array(wb.astype(jnp.float32))).bfloat16(),
        torch.from_numpy(cnt))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0 ** -7 * np.abs(want).max())


def test_transposed_weight_view_is_the_same_product():
    """``w`` given as the transpose of an ``[E, F, H]`` tensor (the
    backward's dx operand) gives the product of its contiguous copy."""
    x, w, cnt, _ = _inputs(3, 7, 16, 40, [7, 2, 0], seed=3)
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(0, 2, 1)))
    view = wt.transpose(1, 2)
    assert not view.is_contiguous()
    tx, tc = torch.from_numpy(x), torch.from_numpy(cnt)
    np.testing.assert_array_equal(
        moe_gemm.grouped_matmul(tx, view, tc).numpy(),
        moe_gemm.grouped_matmul(tx, view.contiguous(), tc).numpy())


def test_bad_operands_raise():
    x = torch.zeros(2, 4, 8)
    w = torch.zeros(2, 8, 16)
    c = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(ValueError):
        moe_gemm.grouped_matmul(x, torch.zeros(3, 8, 16), c)
    with pytest.raises(ValueError):
        moe_gemm.grouped_matmul(x, torch.zeros(2, 9, 16), c)
    with pytest.raises(ValueError):
        moe_gemm.grouped_matmul(x, w, torch.tensor([1], dtype=torch.int32))
    with pytest.raises(TypeError):
        moe_gemm.grouped_matmul(x, w.double(), c)
    with pytest.raises(TypeError):
        moe_gemm.grouped_matmul(x, w, c.float())
