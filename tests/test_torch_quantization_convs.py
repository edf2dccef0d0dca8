"""paddle_tpu_torch's ``QuantizedConv2D`` and ``QuantizedConv2DTranspose``
against the JAX package's, on the CPU (split from
``test_torch_quantization_layers.py``, whose helpers it shares): forward
over two batches in training mode and the straight-through gradient of x,
to 1e-4 relative of the largest reference value (the convolutions sum in
another order).
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
from test_torch_quantization_layers import _run


@pytest.mark.parametrize("transpose", [False, True])
def test_quantized_convs_equal_jax(transpose):
    paddle.seed(9)
    if transpose:
        jconv = jnn.Conv2DTranspose(4, 3, 3, stride=2, padding=1)
        tconv = torch.nn.ConvTranspose2d(4, 3, 3, stride=2, padding=1)
        cls = "QuantizedConv2DTranspose"
    else:
        jconv = jnn.Conv2D(3, 4, 3, stride=1, padding=1)
        tconv = torch.nn.Conv2d(3, 4, 3, stride=1, padding=1)
        cls = "QuantizedConv2D"
    with torch.no_grad():
        tconv.weight.copy_(torch.from_numpy(_f32(jconv.weight)))
        tconv.bias.copy_(torch.from_numpy(_f32(jconv.bias)))
    jl = getattr(JQ.quant_layers, cls)(jconv)
    tl = getattr(TQ.quant_layers, cls)(tconv)
    x = np.random.default_rng(10).standard_normal(
        (2, 4 if transpose else 3, 6, 6)).astype(np.float32)
    _run(jl, tl, x, steps=2, rel=1e-4)
    if transpose:
        # the reference drops output_size (its conv2d_transpose takes it
        # and never reads it); the port honours it, as torch's and
        # Paddle's layers do: the extra row and column come from
        # output_padding 1, and the rest is the reference's output
        jy = jl(paddle.to_tensor(x), output_size=[12, 12])
        ty = tl(torch.from_numpy(x), output_size=[12, 12])
        assert tuple(ty.shape) == (2, 3, 12, 12)
        assert tuple(jy.shape) == (2, 3, 11, 11)
        _close(ty[..., :11, :11], jy, 1e-4)
