"""paddle_tpu_torch's weight-only and A8W8 products (``ops/kernels/wo_matmul.py``,
``a8w8_matmul.py``, ``nn.quant.weight_only_linear``, ``llm_int8_linear``)
against the JAX package's kernels in interpret mode and its composites, on
the CPU (split from ``test_torch_quant.py``, whose helpers and tolerances
it shares).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.nn import quant as JQ
from paddle_tpu.ops.kernels import _common as jax_kern
from paddle_tpu.ops.kernels import a8w8_matmul_pallas as jax_a8
from paddle_tpu.ops.kernels import wo_matmul_pallas as jax_wo
from paddle_tpu_torch.nn import quant as TQ
from paddle_tpu_torch.ops.kernels import a8w8_matmul as a8
from paddle_tpu_torch.ops.kernels import wo_matmul as wo

from test_torch_quant import (  # noqa: F401 — shared helpers
    F32, _bf16_close, _llm_inputs, _np, _pinned, cpu_rule)


def _wo_inputs(m, k, n, kind, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(m + (k,)).astype(np.float32)
    if kind == "int4":
        w = rng.integers(-128, 128, (k, n // 2)).astype(np.int8)
    else:
        w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    s_shape = (k // 16, n) if kind == "int8_grouped" else (n,)
    s = (rng.random(s_shape) * 0.05 + 0.01).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return (jx, jnp.asarray(w), jnp.asarray(s)), \
        (tx, torch.from_numpy(w), torch.from_numpy(s))


@pytest.mark.parametrize("kind", ["int8", "int8_grouped", "int4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [(1,), (5,), (2, 3)])
def test_wo_matmul_plain_equals_jax_kernel(kind, dtype, m):
    k, n = 64, 96
    (jx, jw, js), (tx, tw, ts) = _wo_inputs(m, k, n, kind, dtype,
                                            seed=len(m) + m[0])
    if kind == "int4":
        want = jax_wo.wo_int4_matmul(jx, jw, js, interpret=True)
        composite = jax_wo.reference_wo_int4_matmul(jx, jw, js)
        got = wo.wo_int4_matmul(tx, tw, ts)
        assert torch.equal(got, wo.wo_int4_matmul_plain(tx, tw, ts))
    else:
        want = jax_wo.wo_int8_matmul(jx, jw, js, interpret=True)
        composite = jax_wo.reference_wo_int8_matmul(jx, jw, js)
        got = wo.wo_int8_matmul(tx, tw, ts)
        assert torch.equal(got, wo.wo_int8_matmul_plain(tx, tw, ts))
    assert got.shape == m + (n,) and str(got.dtype) == f"torch.{dtype}"
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), **F32)
        np.testing.assert_allclose(_np(got), _np(composite), **F32)
    else:
        _bf16_close(_np(got), _np(want))
        _bf16_close(_np(got), _np(composite), ulps=4 / 2)


def test_wo_matmul_checks_like_jax():
    x = torch.randn(2, 32)
    with pytest.raises(ValueError, match="int8"):
        wo.wo_int8_matmul(x, torch.zeros(32, 8), torch.ones(8))
    with pytest.raises(ValueError, match="divide"):
        wo.wo_int8_matmul(x, torch.zeros(32, 8, dtype=torch.int8),
                          torch.ones(5, 8))
    with pytest.raises(ValueError, match="cover"):
        wo.wo_int4_matmul(x, torch.zeros(32, 4, dtype=torch.int8),
                          torch.ones(6))
    with pytest.raises(ValueError, match="int8"):
        wo.wo_int4_matmul(x, torch.zeros(32, 4, dtype=torch.uint8),
                          torch.ones(8))


@pytest.mark.parametrize("algo,gs,n", [
    ("weight_only_int8", -1, 48), ("weight_only_int8", 16, 48),
    ("weight_only_int4", -1, 48), ("weight_only_int4", -1, 17),
    ("weight_only_int4", 16, 48), ("weight_only_int4", 16, 17)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_only_linear_equals_jax(algo, gs, n, dtype):
    """The whole linear, bias included, against the JAX package's with its
    kernels in interpret mode (grouped int4: unpacked to dense int8 first,
    then the grouped int8 kernel, on both sides)."""
    rng = np.random.default_rng(n + gs)
    k = 64
    w = rng.standard_normal((k, n)).astype(np.float32)
    x = rng.standard_normal((2, 3, k)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    jq, js = JQ.weight_quantize(paddle.to_tensor(w), algo=algo, group_size=gs)
    wdt = algo.split("_")[-1]
    jax_kern.force_interpret(True)
    try:
        want = JQ.weight_only_linear(paddle.to_tensor(x).astype(dtype), jq,
                                     bias=paddle.to_tensor(b).astype(dtype),
                                     weight_scale=js, weight_dtype=wdt)
    finally:
        jax_kern.force_interpret(False)
    tq, ts = TQ.weight_quantize(torch.from_numpy(w), algo=algo, group_size=gs)
    tdt = getattr(torch, dtype)
    got = TQ.weight_only_linear(torch.from_numpy(x).to(tdt), tq,
                                bias=torch.from_numpy(b).to(tdt),
                                weight_scale=ts, weight_dtype=wdt)
    assert tuple(got.shape) == (2, 3, n) and got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), **F32)
    else:
        # one ulp for the product plus one for the bias add
        _bf16_close(_np(got), _np(want), ulps=2)


def test_weight_only_linear_checks():
    x = torch.randn(2, 8)
    with pytest.raises(ValueError):
        TQ.weight_only_linear(x, torch.zeros(8, 4, dtype=torch.int8),
                              weight_scale=torch.ones(4), weight_dtype="int2")
    with pytest.raises(ValueError, match="weight_scale"):
        TQ.weight_only_linear(x, torch.zeros(8, 4, dtype=torch.int8))


@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("m", [300, 7])
def test_a8w8_plain_bit_identical_to_jax_kernel(layout, m):
    rng = np.random.default_rng(m)
    k, n = 384, 272
    x = _pinned(m, k, seed=m)
    wkn = rng.integers(-127, 128, (k, n)).astype(np.int8)
    ws = (rng.random(n) * 0.02 + 0.01).astype(np.float32)
    w = wkn if layout == "kn" else np.ascontiguousarray(wkn.T)
    want = jax_a8.a8w8_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                              jnp.asarray(ws), layout=layout, interpret=True)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    got = a8.a8w8_matmul(tx, torch.from_numpy(w), torch.from_numpy(ws),
                         layout)
    assert torch.equal(got, a8.a8w8_matmul_plain(
        tx, torch.from_numpy(w), torch.from_numpy(ws), layout))
    np.testing.assert_array_equal(_np(got), _np(want))
    ref = jax_a8.reference_a8w8(jnp.asarray(x, jnp.bfloat16),
                                jnp.asarray(wkn), jnp.asarray(ws))
    np.testing.assert_array_equal(_np(got), _np(ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a8w8_plain_equals_jax_kernel_on_random_inputs(dtype):
    rng = np.random.default_rng(11)
    m, k, n = 130, 256, 96
    x = rng.standard_normal((2, m // 2, k)).astype(np.float32)
    w = rng.integers(-127, 128, (n, k)).astype(np.int8)
    ws = (rng.random(n) * 0.02 + 0.01).astype(np.float32)
    want = jax_a8.a8w8_matmul(jnp.asarray(x, dtype), jnp.asarray(w),
                              jnp.asarray(ws), layout="nk", interpret=True)
    got = a8.a8w8_matmul(torch.from_numpy(x).to(getattr(torch, dtype)),
                         torch.from_numpy(w), torch.from_numpy(ws), "nk")
    assert got.shape == (2, m // 2, n)
    # the same q wherever x / s is not within an ulp of a half: f32 to the
    # f32 sum's order, bf16 to one ulp
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), **F32)
    else:
        _bf16_close(_np(got), _np(want))


def test_a8w8_checks_and_dispatch_rule():
    assert a8.use_kernel(128, 256) == jax_a8.use_kernel(128, 256) is True
    for mk in ((127, 256), (128, 255), (1, 4096)):
        assert a8.use_kernel(*mk) == jax_a8.use_kernel(*mk) is False
    x = torch.randn(4, 32)
    with pytest.raises(ValueError, match="int8"):
        a8.a8w8_matmul(x, torch.zeros(32, 8), torch.ones(8))
    with pytest.raises(ValueError, match="layout"):
        a8.a8w8_matmul(x, torch.zeros(32, 8, dtype=torch.int8), torch.ones(8),
                       "nn")


@pytest.mark.parametrize("m,interpret", [
    (256, True),       # kernel branch: the JAX package's A8W8 kernel
    (64, False),       # composite branch: below 128 rows
])
def test_llm_int8_linear_equals_jax(m, interpret):
    x, w, s, b = _llm_inputs(m)
    jax_kern.force_interpret(interpret)
    try:
        want = JQ.llm_int8_linear(paddle.to_tensor(x), paddle.to_tensor(w),
                                  bias=paddle.to_tensor(b),
                                  weight_scale=paddle.to_tensor(s))
    finally:
        jax_kern.force_interpret(False)
    got = TQ.llm_int8_linear(torch.from_numpy(x), torch.from_numpy(w),
                             bias=torch.from_numpy(b),
                             weight_scale=torch.from_numpy(s))
    assert got.shape == (m, 160) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-4)


def test_llm_int8_linear_grad_takes_the_composite():
    """An input that needs a gradient keeps the composite branch (and its
    gradient through the outlier columns), on both sides."""
    x, w, s, b = _llm_inputs(256)
    xj = paddle.to_tensor(x)
    xj.stop_gradient = False
    jax_kern.force_interpret(True)
    try:
        want = JQ.llm_int8_linear(xj, paddle.to_tensor(w),
                                  bias=paddle.to_tensor(b),
                                  weight_scale=paddle.to_tensor(s))
    finally:
        jax_kern.force_interpret(False)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = TQ.llm_int8_linear(xt, torch.from_numpy(w), bias=torch.from_numpy(b),
                             weight_scale=torch.from_numpy(s))
    np.testing.assert_allclose(got.detach().numpy(), _np(want), rtol=1e-5,
                               atol=1e-4)
    got.sum().backward()
    want.sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), _np(xj.grad), rtol=1e-5,
                               atol=1e-4)
    assert xt.grad[:, 7].abs().sum() > 0          # the outlier column
