"""paddle_tpu_torch's quantization primitives and PTQ flow against the JAX
package, on the CPU: the exports, ``fake_quant`` and its straight-through
gradient, the weight-only VJP (``dx`` and ``ds`` of ``dequant_matmul_int8``
/ ``_int4`` and of ``weight_only_linear``), PTQ with its observers, the
configs' precedence, the quanters and the wrappers. QAT, the quant layers
and a PTQ-converted ``llama_tiny`` are in ``test_torch_quantization_qat.py``,
``_layers.py`` and ``_llama.py``, which share these helpers.

The same numpy inputs, made from a seed, go to both packages; JAX weights
``[in, out]`` go across transposed into ``torch.nn.Linear``'s ``[out, in]``.
On the CPU every port wrapper takes its plain version (the launch counters
stay at 0); the JAX side runs eagerly, its weight-only products through
its composite. Tolerances, each beside its check:

- fake quantization in f32: values and STE gradients exact;
- ``dx`` / ``ds``: f32 to ``1e-5`` relative to the largest reference value
  (the same products summed in another order); bf16 ``dx`` to two bf16
  ulps of the largest reference value (``2 * 2**-7 * max|ref|``: one
  bf16 product and one rounding of the f32 sum on each side); ``ds``
  (summed in f32 on both sides) to ``1e-5``;
- PTQ: observer scales and int8 weights exact, outputs to ``1e-5``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.quant as JQ
import paddle_tpu.quantization as JQZ
from paddle_tpu.quantization import functional as JF
from paddle_tpu_torch.nn import quant as TQ
from paddle_tpu_torch.ops.kernels import WRAPPERS
from paddle_tpu_torch import quantization as TQZ
from paddle_tpu_torch.quantization import functional as TF

QUANT_KERNELS = ("wo_int8", "wo_int8_grouped", "wo_int4")


@pytest.fixture(autouse=True)
def cpu_rule():
    """Every test here runs on CPU tensors: no kernel may launch."""
    for name in QUANT_KERNELS:
        WRAPPERS[name].launches = 0
    yield
    assert all(WRAPPERS[n].launches == 0 for n in QUANT_KERNELS)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    if hasattr(a, "numpy") and not isinstance(a, np.ndarray):
        a = a.numpy()
    return np.asarray(a).astype(np.float32)


def _close(got, ref, rel):
    got, ref = _f32(got), _f32(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    tol = rel * max(float(np.abs(ref).max()), 1e-30)
    assert np.abs(got - ref).max() <= tol, (np.abs(got - ref).max(), tol)


def test_exports_equal_jax():
    assert sorted(TQZ.__all__) == sorted(JQZ.__all__)
    assert sorted(TQ.__all__) == sorted(JQ.__all__)
    assert sorted(TQ.quant_layers.__all__) == \
        sorted(JQ.quant_layers.__all__)
    for name in TQZ.__all__:
        assert hasattr(TQZ, name), name
    for name in TQ.__all__ + ["QuantStub", "quanted_layer_types"]:
        assert hasattr(TQ, name), name
    assert TQ.quanted_layer_types() == [TQZ.QuantedLinear,
                                        TQZ.Int8WeightOnlyLinear]
    x = torch.randn(3)
    assert TQ.QuantStub is TQ.Stub and torch.equal(TQ.Stub()(x), x)


# -- fake quantization ---------------------------------------------------------------

@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("scale", ["number", "tensor", "channel"])
def test_fake_quant_values_and_ste_equal_jax(bits, scale):
    rng = np.random.default_rng(bits)
    x = rng.standard_normal((6, 5)).astype(np.float32)
    up = rng.standard_normal((6, 5)).astype(np.float32)
    s = {"number": 1.3, "tensor": np.float32(0.9),
         "channel": (rng.random((1, 5)) + 0.5).astype(np.float32)}[scale]
    js = s if scale == "number" else jnp.asarray(s)
    ts = s if scale == "number" else torch.from_numpy(np.asarray(s))
    want, vjp = jax.vjp(lambda a: JF.fake_quant_array(a, js, bits),
                        jnp.asarray(x))
    (jgrad,) = vjp(jnp.asarray(up))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = TF.fake_quant(tx, ts, bit_length=bits)
    got.backward(torch.from_numpy(up))
    np.testing.assert_array_equal(_f32(got), np.asarray(want))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jgrad))
    np.testing.assert_array_equal(tx.grad.numpy(), up)       # identity
    # the JAX test's case: q = round(x * 127) / 127
    v = torch.tensor([0.5, -1.0, 0.26], requires_grad=True)
    out = TF.fake_quant(v, 1.0, bit_length=8)
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.round(np.array([0.5, -1.0, 0.26]) * 127) / 127, atol=1e-6)


# -- the weight-only VJP ---------------------------------------------------------------

def _wo_case(kind, dtype, seed, m=(3, 5), k=32, n=48):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(m + (k,)).astype(np.float32)
    g = rng.standard_normal(m + (n,)).astype(np.float32)
    if kind == "int4":
        w = rng.integers(-128, 128, (k, n // 2)).astype(np.int8)
    else:
        w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    s = (rng.random((k // 8, n) if kind == "int8_grouped" else (n,))
         * 0.05 + 0.01).astype(np.float32)
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    return ((jnp.asarray(x, jd), jnp.asarray(w), jnp.asarray(s),
             jnp.asarray(g, jd)),
            (torch.from_numpy(x).to(td), torch.from_numpy(w),
             torch.from_numpy(s), torch.from_numpy(g).to(td)))


@pytest.mark.parametrize("kind", ["int8", "int8_grouped", "int4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_only_vjp_equals_jax(kind, dtype):
    (jx, jw, js, jg), (tx, tw, ts, tg) = _wo_case(kind, dtype, 7)
    jfn = JF.dequant_matmul_int4 if kind == "int4" else JF.dequant_matmul_int8
    tfn = TF.dequant_matmul_int4 if kind == "int4" else TF.dequant_matmul_int8
    want, vjp = jax.vjp(lambda a, s: jfn(a, jw, s), jx, js)
    jdx, jds = vjp(jg)
    tx.requires_grad_(True)
    ts.requires_grad_(True)
    got = tfn(tx, tw, ts)
    dx, ds = torch.autograd.grad(got, (tx, ts), tg)
    assert dx.dtype == tx.dtype and ds.dtype == ts.dtype
    assert dx.shape == tx.shape and ds.shape == ts.shape
    if dtype == "float32":
        _close(got, want, 1e-5)
        _close(dx, jdx, 1e-5)
    else:
        _close(got, want, 4 * 2.0 ** -8)       # JAX's composite rounds 4x
        _close(dx, jdx, 2 * 2.0 ** -7)
    _close(ds, jds, 1e-5)
    # the plain route on any device gives the same gradients
    dx_p, ds_p = torch.autograd.grad(tfn(tx, tw, ts, plain=True), (tx, ts),
                                     tg)
    assert torch.equal(dx_p, dx) and torch.equal(ds_p, ds)


def test_weight_only_vjp_skips_what_is_not_needed(monkeypatch):
    """``ds`` (and its f32 recompute) only when the scales need a
    gradient; ``dx`` only when x does; the int weight gets none; the input
    is kept for the backward only when ``ds`` will read it."""
    (_, _, _, _), (tx, tw, ts, tg) = _wo_case("int8", "float32", 3)
    calls = []
    real = torch.matmul
    monkeypatch.setattr(torch, "matmul",
                        lambda *a: calls.append(a) or real(*a))
    tx.requires_grad_(True)
    y = TF.dequant_matmul_int8(tx, tw, ts)
    assert y.grad_fn.saved_tensors[0] is None
    (dx,) = torch.autograd.grad(y, (tx,), tg)
    assert len(calls) == 1 and dx.shape == tx.shape      # dx's product only
    calls.clear()
    ts.requires_grad_(True)
    y = TF.dequant_matmul_int8(tx.detach(), tw, ts)
    assert torch.equal(y.grad_fn.saved_tensors[0], tx)
    (ds,) = torch.autograd.grad(y, (ts,), tg)
    assert len(calls) == 1 and ds.shape == ts.shape      # u = x @ w only
    assert not tw.requires_grad


@pytest.mark.parametrize("algo,gs,n", [("weight_only_int8", -1, 48),
                                       ("weight_only_int8", 8, 48),
                                       ("weight_only_int4", -1, 47),
                                       ("weight_only_int4", 8, 48)])
def test_weight_only_linear_grads_equal_jax(algo, gs, n):
    """``nn.quant.weight_only_linear`` takes JAX's gradients, grouped int4
    (unpacked to int8) and odd N (the zero pad column) included."""
    rng = np.random.default_rng(n + gs)
    w = rng.standard_normal((32, n)).astype(np.float32)
    x = rng.standard_normal((4, 32)).astype(np.float32)
    b = rng.standard_normal((n,)).astype(np.float32)
    up = rng.standard_normal((4, n)).astype(np.float32)
    jq, js = JQ.weight_quantize(paddle.to_tensor(w), algo=algo,
                                group_size=gs)
    wd = "int4" if algo == "weight_only_int4" else "int8"
    jxt, jst, jbt = (paddle.to_tensor(x), paddle.to_tensor(_f32(js)),
                     paddle.to_tensor(b))
    for t in (jxt, jst, jbt):
        t.stop_gradient = False
    jy = JQ.weight_only_linear(jxt, jq, bias=jbt, weight_scale=jst,
                               weight_dtype=wd, group_size=gs)
    (jy * paddle.to_tensor(up)).sum().backward()
    tq, ts = TQ.weight_quantize(torch.from_numpy(w), algo=algo,
                                group_size=gs)
    tx = torch.from_numpy(x).requires_grad_(True)
    ts = ts.clone().requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    ty = TQ.weight_only_linear(tx, tq, bias=tb, weight_scale=ts,
                               weight_dtype=wd, group_size=gs)
    ty.backward(torch.from_numpy(up))
    _close(ty, jy, 1e-5)
    _close(tx.grad, jxt.grad, 1e-5)
    _close(ts.grad, jst.grad, 1e-5)
    _close(tb.grad, jbt.grad, 1e-5)


# -- QAT, PTQ, configs, observers, wrappers ------------------------------------------

def _nets(seed=0):
    """The JAX test's Sequential(Linear(8, 32), ReLU, Linear(32, 4)) and
    its port twin holding the same weights."""
    paddle.seed(seed)
    jm = jnn.Sequential(jnn.Linear(8, 32), jnn.ReLU(), jnn.Linear(32, 4))
    tm = torch.nn.Sequential(torch.nn.Linear(8, 32), torch.nn.ReLU(),
                             torch.nn.Linear(32, 4))
    with torch.no_grad():
        for i in (0, 2):
            tm[i].weight.copy_(torch.from_numpy(
                _f32(jm._sub_layers[str(i)].weight).T.copy()))
            tm[i].bias.copy_(torch.from_numpy(
                _f32(jm._sub_layers[str(i)].bias)))
    return jm, tm


def test_quanter_forward_reads_nothing_back(monkeypatch):
    q = TQZ.FakeQuanterWithAbsMaxObserver()
    monkeypatch.setattr(torch.Tensor, "item", lambda *a: 1 / 0)
    monkeypatch.setattr(torch.Tensor, "__float__", lambda *a: 1 / 0)
    out = q(torch.randn(4, 4))
    assert out.shape == (4, 4)
    monkeypatch.undo()
    assert q.scale() > 0 and q.zero_points() is None
    q.eval()
    before = q.scales().clone()
    q(torch.randn(4, 4) * 100)
    assert torch.equal(q.scales(), before)             # eval: no update


def test_quanter_factory_decorator():
    @TQZ.quanter("MyQuanter")
    class _Q(TQZ.BaseQuanter):
        def __init__(self, k=1):
            super().__init__()
            self.k = k

    fac = TQZ.MyQuanter(k=3)
    assert fac._instance(None).k == 3 and isinstance(fac(), _Q)


def test_ptq_calibrates_and_converts_like_jax():
    jm, tm = _nets(1)
    jptq = JQZ.PTQ(JQZ.QuantConfig(activation=JQZ.AbsmaxObserver(),
                                   weight=None))
    tptq = TQZ.PTQ(TQZ.QuantConfig(activation=TQZ.AbsmaxObserver(),
                                   weight=None))
    jc, tc = jptq.quantize(jm), tptq.quantize(tm)
    xs = np.random.default_rng(1).standard_normal((4, 16, 8)) \
        .astype(np.float32)
    for b in xs:
        jc(paddle.to_tensor(b))
        tc(torch.from_numpy(b))
    for i in ("0", "2"):
        assert tc[int(i)].observer.scale() == \
            jc._sub_layers[i].observer.scale() > 0
    j8, t8 = jptq.convert(jc), tptq.convert(tc)
    for i in ("0", "2"):
        jl, tl = j8._sub_layers[i], t8[int(i)]
        assert isinstance(tl, TQZ.Int8WeightOnlyLinear)
        assert tl.weight_int8.dtype == torch.int8
        np.testing.assert_array_equal(tl.weight_int8.numpy(),
                                      np.asarray(jl.weight_int8.numpy()))
        np.testing.assert_array_equal(tl.scales.numpy(),
                                      np.asarray(jl.scales.numpy()))
        assert tl.memory_bytes() == jl.memory_bytes()
        assert not tl.weight_int8.requires_grad and \
            not tl.scales.requires_grad
    x = xs[0]
    _close(t8(torch.from_numpy(x)), j8(paddle.to_tensor(x)), 1e-5)
    lin = torch.nn.Linear(128, 256)
    assert TQZ.Int8WeightOnlyLinear(lin).memory_bytes() < 128 * 256 * 4 / 3.5
    # observers' factories and the moving-average observer
    mo = TQZ.MovingAverageMinMaxObserver(moving_rate=0.5)
    jmo = JQZ.MovingAverageMinMaxObserver(moving_rate=0.5)
    for b in xs:
        mo.observe(torch.from_numpy(b))
        jmo.observe(paddle.to_tensor(b))
    assert mo.scale() == pytest.approx(jmo.scale(), rel=1e-7)
    assert type(mo._instance(None)) is TQZ.MovingAverageMinMaxObserver
    assert TQZ.MovingAverageMinMaxObserver().scale() == 1e-9


def test_quant_config_precedence():
    q1, q2, q3, q4 = (TQZ.FakeQuanterWithAbsMaxObserver() for _ in range(4))
    _, tm = _nets(2)
    cfg = TQZ.QuantConfig(activation=q4, weight=None)
    cfg.add_type_config(torch.nn.Linear, activation=q3)
    cfg.add_name_config(["2"], activation=q2)
    cfg.add_layer_config(tm[2], activation=q1)
    assert cfg.config_for(tm[2], "2").activation is q1          # layer
    assert cfg.config_for(torch.nn.Linear(2, 2), "2").activation is q2
    assert cfg.config_for(tm[0], "0").activation is q3          # type
    assert cfg.config_for(tm[1], "1").activation is q4          # global
    assert "Global config" in str(cfg)
    # the JAX test's name / type configs pick the same layers
    for add in ("type", "name"):
        jm, tm = _nets(2)
        jq, tq = JQZ.FakeQuanterWithAbsMaxObserver(), \
            TQZ.FakeQuanterWithAbsMaxObserver()
        jc, tc = JQZ.QuantConfig(), TQZ.QuantConfig()
        if add == "type":
            jc.add_type_config(jnn.Linear, activation=jq, weight=jq)
            tc.add_type_config(torch.nn.Linear, activation=tq, weight=tq)
        else:
            jc.add_name_config("0", activation=jq, weight=jq)
            tc.add_name_config("0", activation=tq, weight=tq)
        jqm, tqm = JQZ.QAT(jc).quantize(jm), TQZ.QAT(tc).quantize(tm)
        for i in ("0", "2"):
            assert isinstance(tqm[int(i)], TQZ.QuantedLinear) == \
                isinstance(jqm._sub_layers[i], JQZ.QuantedLinear)


# -- nn.quant.quant_layers ------------------------------------------------------------


# -- a PTQ-converted llama_tiny --------------------------------------------------------
