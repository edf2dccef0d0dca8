"""Fused layers of ``incubate.nn`` (counterpart of
``paddle_tpu/incubate/nn/layer.py`` ``FusedLinear``, ``FusedDropoutAdd``
and ``FusedBiasDropoutResidualLayerNorm``, :25-83), as ``nn.Module`` s on
an explicit device (default ``cuda``) and dtype.

Parameter names are JAX's (``weight``, ``bias``, ``linear_bias``,
``ln_scale``, ``ln_bias``) and ``FusedLinear`` keeps Paddle's ``[in,
out]`` weight (``[out, in]`` with ``transpose_weight``), so a JAX layer's
``state_dict()`` loads unchanged (``models.convert.incubate_from_jax_state``).
Weights are drawn from a seeded ``torch.Generator`` with JAX's default
initializers: Xavier-normal weights, zero biases, unit ``ln_scale``.
The two layers with kernels take ``plain=True`` in ``forward`` to run the
plain versions. ``weight_attr``, a ``bias_attr`` other than False and
``name`` are taken for Paddle's signatures and not read.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ...device import resolve_device
from . import functional as IF

__all__ = ["FusedLinear", "FusedDropoutAdd",
           "FusedBiasDropoutResidualLayerNorm"]


def _param(shape, device, dtype, fill=None, gen=None):
    if fill is not None:
        t = torch.full(shape, float(fill), device=device, dtype=dtype)
    else:
        std = math.sqrt(2.0 / (shape[0] + shape[1]))
        t = (torch.randn(shape, generator=gen, device=device) * std).to(dtype)
    return nn.Parameter(t)


class FusedLinear(nn.Module):
    """``x @ weight + bias`` (reference ``fused_linear.py``); ``bias_attr
    =False`` leaves the bias out."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, transpose_weight=False, name=None,
                 device=None, dtype=torch.float32, seed=0):
        super().__init__()
        dev = resolve_device(device)
        self.transpose_weight = transpose_weight
        shape = ((out_features, in_features) if transpose_weight
                 else (in_features, out_features))
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        self.weight = _param(shape, dev, dtype, gen=gen)
        self.bias = None if bias_attr is False else \
            _param((out_features,), dev, dtype, fill=0.0)

    def forward(self, x):
        return IF.fused_linear(x, self.weight, self.bias,
                               transpose_weight=self.transpose_weight)


class FusedDropoutAdd(nn.Module):
    """``dropout(x) + y`` in one kernel (reference
    ``fused_dropout_add.py``); dropout only in training."""

    def __init__(self, p=0.5, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.mode = mode

    def forward(self, x, y, plain=False):
        return IF.fused_dropout_add(x, y, p=self.p, training=self.training,
                                    mode=self.mode, plain=plain)

    def extra_repr(self):
        return f"p={self.p}, mode={self.mode}"


class FusedBiasDropoutResidualLayerNorm(nn.Module):
    """``layer_norm(dropout(x + linear_bias) + residual)`` in one kernel
    (reference ``fused_transformer.py``)."""

    def __init__(self, embed_dim, dropout_rate=0.5, weight_attr=None,
                 bias_attr=None, epsilon=1e-5, name=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.embed_dim = embed_dim
        self.dropout_rate = dropout_rate
        self.epsilon = epsilon
        self.linear_bias = _param((embed_dim,), dev, dtype, fill=0.0)
        self.ln_scale = _param((embed_dim,), dev, dtype, fill=1.0)
        self.ln_bias = _param((embed_dim,), dev, dtype, fill=0.0)

    def forward(self, x, residual, plain=False):
        return IF.fused_bias_dropout_residual_layer_norm(
            x, residual, bias=self.linear_bias, ln_scale=self.ln_scale,
            ln_bias=self.ln_bias, dropout_rate=self.dropout_rate,
            ln_epsilon=self.epsilon, training=self.training, plain=plain)
