"""paddle_tpu_torch's ``nn.quant.quant_layers`` against the JAX package's, on
the CPU (beside ``test_torch_quantization.py``, whose helpers it shares):
every class but the convolutions (``test_torch_quantization_convs.py``),
forward over several batches in training mode (the moving scales move)
and the straight-through gradient of x; outputs and gradients to 1e-5
relative of the largest reference value, moving-average scales to 1e-6.
"""


import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.quant as JQ
from paddle_tpu_torch.nn import quant as TQ

from test_torch_quantization import (  # noqa: F401 — shared helpers
    _close, _f32, cpu_rule)


def _pair(np_x):
    jx = paddle.to_tensor(np_x)
    jx.stop_gradient = False
    return jx, torch.from_numpy(np_x).requires_grad_(True)


def _run(jlayer, tlayer, np_x, steps=3, rel=1e-5, up_seed=0):
    """Forward ``steps`` batches (scaled so moving scales move) through
    both layers in train mode, outputs and x's STE gradient compared."""
    up = None
    for i in range(steps):
        jx, tx = _pair(np_x * (1.0 + i))
        jy, ty = jlayer(jx), tlayer(tx)
        _close(ty, jy, rel)
        up = np.random.default_rng(up_seed + i).standard_normal(
            ty.shape).astype(np.float32)
        (jy * paddle.to_tensor(up)).sum().backward()
        ty.backward(torch.from_numpy(up))
        _close(tx.grad, jx.grad, rel)


@pytest.mark.parametrize("name", ["FakeQuantAbsMax",
                                  "FakeQuantChannelWiseAbsMax",
                                  "FakeQuantMovingAverageAbsMax",
                                  "MovingAverageAbsMaxScale"])
def test_fake_quant_layers_equal_jax(name):
    kw = dict(quant_axis=1) if name == "FakeQuantChannelWiseAbsMax" else {}
    kw.update(quant_bits=4) if name == "FakeQuantAbsMax" else None
    jl = getattr(JQ.quant_layers, name)(**kw)
    tl = getattr(TQ.quant_layers, name)(**kw)
    x = np.random.default_rng(5).standard_normal((6, 5)).astype(np.float32)
    _run(jl, tl, x)
    if name == "MovingAverageAbsMaxScale":
        _close(tl.scale, jl.scale, 1e-6)
    if name == "FakeQuantMovingAverageAbsMax":
        _close(tl._ma.scale, jl._ma.scale, 1e-6)
        tl.eval()
        jl.eval()
        _run(jl, tl, x * 5, steps=1)        # eval: the scale holds still


def _linears(seed):
    paddle.seed(seed)
    jlin = jnn.Linear(8, 6)
    tlin = torch.nn.Linear(8, 6)
    with torch.no_grad():
        tlin.weight.copy_(torch.from_numpy(_f32(jlin.weight).T.copy()))
        tlin.bias.copy_(torch.from_numpy(_f32(jlin.bias)))
    return jlin, tlin


@pytest.mark.parametrize("name", ["QuantizedLinear", "MAOutputScaleLayer",
                                  "FakeQuantMAOutputScaleLayer",
                                  "QuantizedColumnParallelLinear",
                                  "QuantizedRowParallelLinear"])
def test_linear_wrappers_equal_jax(name):
    jlin, tlin = _linears(4)
    jl = getattr(JQ.quant_layers, name)(jlin)
    tl = getattr(TQ.quant_layers, name)(tlin)
    x = np.random.default_rng(6).standard_normal((5, 8)).astype(np.float32)
    _run(jl, tl, x)
    if name in ("QuantizedLinear", "QuantizedColumnParallelLinear"):
        assert tl.weight is tlin.weight and tl.bias is tlin.bias
    if name == "QuantizedColumnParallelLinear":
        tlin.world_size = 2
        with pytest.raises(NotImplementedError, match="ranks"):
            TQ.quant_layers.QuantizedColumnParallelLinear(tlin)


def test_quantized_linear_weight_quantize_types():
    """channel-wise on the port's [out, in] weight along axis 0 is JAX's
    along axis 1 of [in, out]; the moving-average weight quanter too."""
    for wtype, jax_axis, axis in (("channel_wise_abs_max", 1, 0),
                                  ("moving_average_abs_max", 0, 0)):
        jlin, tlin = _linears(5)
        jl = JQ.quant_layers.QuantizedLinear(
            jlin, weight_quantize_type=wtype, weight_quant_axis=jax_axis,
            activation_quantize_type="abs_max")
        tl = TQ.quant_layers.QuantizedLinear(
            tlin, weight_quantize_type=wtype, weight_quant_axis=axis,
            activation_quantize_type="abs_max")
        x = np.random.default_rng(7).standard_normal((5, 8)) \
            .astype(np.float32)
        _run(jl, tl, x, steps=2)


def test_quantized_matmul_equal_jax():
    jl, tl = JQ.quant_layers.QuantizedMatmul(), \
        TQ.quant_layers.QuantizedMatmul()
    rng = np.random.default_rng(8)
    a = rng.standard_normal((2, 4, 6)).astype(np.float32)
    b = rng.standard_normal((2, 5, 6)).astype(np.float32)
    for i in range(2):
        ja, ta = _pair(a * (i + 1))
        jb, tb = _pair(b)
        jy = jl(ja, jb, transpose_y=True)
        ty = tl(ta, tb, transpose_y=True)
        _close(ty, jy, 1e-5)
        ty.sum().backward()
        jy.sum().backward()
        _close(ta.grad, ja.grad, 1e-5)
        _close(tb.grad, jb.grad, 1e-5)
