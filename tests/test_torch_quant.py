"""paddle_tpu_torch's quantization modules (``nn.quant``, ``quantization``,
``ops/kernels/wo_matmul.py``, ``ops/kernels/a8w8_matmul.py``) against the
JAX package, on the CPU.

The same numpy inputs, made from a seed, go to both. On the CPU every
port wrapper takes its plain version (the launch counters stay at 0); the
JAX side runs its Pallas kernels in interpret mode (``interpret=True`` or
``force_interpret``), or its composite where the JAX package itself does.

Tolerances, each beside its check:

- quantized weights, scales, packing and dequantized weights: exact in
  f32; on bf16 weights at most one quantisation step in at most 1% of the
  entries (XLA may fuse the elementwise chain in f32 where torch rounds
  each op to bf16);
- weight-only products against the interpret-mode TPU kernels: f32 to
  1e-5 (the same products summed in another order); bf16 to one bf16 ulp
  of the largest reference value (``2**-7 * max|ref|``: one f32 sum
  rounded once);
- against the JAX composites (``reference_wo_*``), which round ``x @ w``
  and the scale to bf16 before multiplying: four bf16 roundings,
  ``4 * 2**-8 * max|ref|``;
- A8W8 on the pinned construction (``x = q * 2**-5`` with ``|q| = 127``
  pinned, so ``x / s`` is exact): bit-identical.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.nn import quant as JQ
from paddle_tpu.ops.kernels import wo_matmul_pallas as jax_wo
from paddle_tpu.quantization import functional as JF
from paddle_tpu_torch.nn import quant as TQ
from paddle_tpu_torch.ops.kernels import WRAPPERS
from paddle_tpu_torch.ops.kernels import wo_matmul as wo
from paddle_tpu_torch.quantization import functional as TF

QUANT_KERNELS = ("wo_int8", "wo_int8_grouped", "wo_int4", "a8w8")
F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def cpu_rule():
    """Every test here runs on CPU tensors: no kernel may launch."""
    for name in QUANT_KERNELS:
        WRAPPERS[name].launches = 0
    yield
    assert all(WRAPPERS[n].launches == 0 for n in QUANT_KERNELS)


def _np(t):
    """A paddle Tensor, a jax array or a torch tensor as f32/int numpy."""
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.is_floating_point() else t.numpy()
    a = np.asarray(t.numpy() if hasattr(t, "numpy") and not isinstance(
        t, np.ndarray) else t)
    return a.astype(np.float32) if a.dtype.kind == "V" or str(
        a.dtype) == "bfloat16" else a


def _bf16_close(got, ref, ulps=1):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    tol = ulps * 2.0 ** -7 * np.abs(ref).max()
    assert np.abs(got - ref).max() <= tol, (np.abs(got - ref).max(), tol)


# -- weight_quantize / weight_dequantize / packing ----------------------------------

_QUANT_CASES = [
    ("weight_only_int8", -1, (64, 48)),
    ("weight_only_int8", -1, (32, 17)),           # odd N
    ("weight_only_int8", 16, (64, 48)),
    ("weight_only_int4", -1, (64, 48)),
    ("weight_only_int4", -1, (32, 17)),           # odd N: one pad column
    ("weight_only_int4", 8, (64, 48)),
    ("weight_only_int4", 8, (32, 17)),
]


@pytest.mark.parametrize("algo,gs,shape", _QUANT_CASES)
def test_weight_quantize_bytes_equal_jax(algo, gs, shape):
    w = np.random.default_rng(sum(shape)).standard_normal(shape).astype(
        np.float32)
    jq, js = JQ.weight_quantize(paddle.to_tensor(w), algo=algo,
                                group_size=gs)
    tq, ts = TQ.weight_quantize(torch.from_numpy(w), algo=algo,
                                group_size=gs)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tq.is_contiguous() and ts.is_contiguous()
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq.numpy()))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js.numpy()))
    for dt in ("float32", "bfloat16"):
        jd = JQ.weight_dequantize(jq, js, algo=algo, out_dtype=dt)
        td = TQ.weight_dequantize(tq, ts, algo=algo, out_dtype=dt)
        assert tuple(td.shape) == shape
        np.testing.assert_array_equal(_np(td), _np(jd))


@pytest.mark.parametrize("algo,gs,shape", _QUANT_CASES[::2])
def test_weight_quantize_bf16_within_one_step(algo, gs, shape):
    """bf16 weights: the quantized values differ from JAX's by at most one
    step, in at most 1% of the entries; the scales are equal."""
    w = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    jq, js = JQ.weight_quantize(paddle.to_tensor(w).astype("bfloat16"),
                                algo=algo, group_size=gs)
    tq, ts = TQ.weight_quantize(torch.from_numpy(w).to(torch.bfloat16),
                                algo=algo, group_size=gs)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js.numpy()))
    if algo == "weight_only_int4":
        a = wo.unpack_int4_halves(tq).numpy().astype(int)
        b = wo.unpack_int4_halves(torch.from_numpy(
            np.array(jq.numpy()))).numpy().astype(int)
    else:
        a, b = tq.numpy().astype(int), np.asarray(jq.numpy()).astype(int)
    diff = np.abs(a - b)
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01


def test_weight_quantize_checks_like_jax():
    w = torch.ones(8, 8)
    with pytest.raises(ValueError, match="algo"):
        TQ.weight_quantize(w, algo="llm.int8")
    with pytest.raises(ValueError):
        TQ.weight_quantize(w, group_size=0)
    with pytest.raises(ValueError):
        TQ.weight_quantize(w, group_size=3)          # does not divide K
    with pytest.raises(ValueError, match="algo"):
        TQ.weight_dequantize(w.to(torch.int8), torch.ones(8), algo="int2")


@pytest.mark.parametrize("shape", [(16, 24), (3, 2), (1, 64)])
def test_int4_halves_pack_unpack_equal_jax(shape):
    q = np.random.default_rng(0).integers(-7, 8, shape).astype(np.int8)
    jp = jax_wo.pack_int4_halves(jnp.asarray(q))
    tp = wo.pack_int4_halves(torch.from_numpy(q))
    assert tp.dtype == torch.int8
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    every = np.arange(256, dtype=np.int32).astype(np.int8).reshape(16, 16)
    np.testing.assert_array_equal(
        wo.unpack_int4_halves(torch.from_numpy(every)).numpy(),
        np.asarray(jax_wo.unpack_int4_halves(jnp.asarray(every))))
    np.testing.assert_array_equal(wo.unpack_int4_halves(tp).numpy(), q)
    with pytest.raises(ValueError):
        wo.pack_int4_halves(torch.zeros(2, 3, dtype=torch.int8))


def test_quantization_functional_equal_jax():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((40, 24)).astype(np.float32)
    jq, js = JF.quantize_weight_int8(jnp.asarray(w), axis=1)
    tq, ts = TF.quantize_weight_int8(torch.from_numpy(w), axis=1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for axis in (None, 0, 1):
        np.testing.assert_array_equal(
            TF.absmax_scale(torch.from_numpy(w), axis).numpy(),
            np.asarray(JF.absmax_scale(jnp.asarray(w), axis)))


def test_quantized_products_are_inference_only():
    """The calls that once refused a gradient now return JAX's: ``dx``
    and ``ds`` of the weight-only VJP (f32, to 1e-5 relative of the
    largest reference value), and none for the integer weight."""
    import jax
    rng = np.random.default_rng(4)
    xn = rng.standard_normal((2, 16)).astype(np.float32)
    wn = rng.integers(-127, 128, (16, 8)).astype(np.int8)
    sn = (rng.random(8) * 0.1 + 0.01).astype(np.float32)
    up = rng.standard_normal((2, 8)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, s: JF.dequant_matmul_int8(a, jnp.asarray(wn),
                                                        s),
                     jnp.asarray(xn), jnp.asarray(sn))
    jdx, jds = vjp(jnp.asarray(up))
    w = torch.from_numpy(wn)
    for call in (lambda a, s: TF.dequant_matmul_int8(a, w, s),
                 lambda a, s: TQ.weight_only_linear(a, w, weight_scale=s)):
        x = torch.from_numpy(xn).requires_grad_(True)
        s = torch.from_numpy(sn).requires_grad_(True)
        dx, ds = torch.autograd.grad(call(x, s), (x, s), torch.from_numpy(up))
        for got, want in ((dx, jdx), (ds, jds)):
            want = np.asarray(want)
            assert np.abs(got.numpy() - want).max() <= \
                1e-5 * np.abs(want).max()
        assert not w.requires_grad
    with torch.no_grad():
        assert TF.dequant_matmul_int8(x, w, torch.ones(8)).shape == (2, 8)
    with pytest.raises(ValueError, match="per-channel"):
        TF.dequant_matmul_int4(x.detach(), torch.zeros(16, 4, dtype=torch.int8),
                               torch.ones(2, 8))


# -- weight-only products against the interpret-mode TPU kernels --------------------


# -- A8W8 ------------------------------------------------------------------------

def _pinned(m, k, seed=0):
    """``tests/test_kernels_fused.py``'s construction: x = q * 2**-5 with
    integer q and |q| = 127 pinned in column 0, so s = 2**-5 exactly."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, (m, k)).astype(np.float32)
    q[:, 0] = 127.0
    return q * 2.0 ** -5


# -- llm_int8_linear: both branches ------------------------------------------------

def _llm_inputs(m, k=320, n=160, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[:, 7] *= 40.0            # an outlier column through the f32 path
    x[:, 100] *= 40.0
    w = rng.integers(-127, 128, (n, k)).astype(np.int8)
    s = (rng.random(n) * 0.02 + 0.01).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    return x, w, s, b
