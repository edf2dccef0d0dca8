"""Quantized layer wrappers (counterpart of
``paddle_tpu/quantization/wrapper.py``).

Both wrap a ``torch.nn.Linear``, whose weight is ``[out, in]`` (the JAX
``Linear`` keeps ``[in, out]``). ``Int8WeightOnlyLinear`` quantises the
``[in, out]`` view per output channel, into the layout the weight-only
kernels take (``ops/kernels/wo_matmul.py``), and runs its forward through
them: on the card a shape the kernel refuses raises.
"""

from __future__ import annotations

import torch

from .functional import dequant_matmul_int8, quantize_weight_int8

__all__ = ["QuantedLinear", "Int8WeightOnlyLinear"]


class QuantedLinear(torch.nn.Module):
    """Linear with fake-quantized activation and weight (the QAT form)."""

    def __init__(self, inner, activation_quanter=None, weight_quanter=None):
        super().__init__()
        self.inner = inner
        self.activation_quanter = activation_quanter
        self.weight_quanter = weight_quanter

    def forward(self, x):
        w = self.inner.weight
        if self.activation_quanter is not None:
            x = self.activation_quanter(x)
        if self.weight_quanter is not None:
            w = self.weight_quanter(w)
        return torch.nn.functional.linear(x, w, self.inner.bias)


class Int8WeightOnlyLinear(torch.nn.Module):
    """Inference linear holding int8 ``[in, out]`` weights and f32
    per-output-channel scales; the bias stays as it was. Activations get
    JAX's gradient through the weight-only VJP, so a model can train
    around frozen int8 projections. ``plain = True`` runs the kernel's
    plain version on any device (a model's forward does not pass its own
    ``plain`` on to a Linear)."""

    def __init__(self, linear):
        super().__init__()
        with torch.no_grad():
            q, s = quantize_weight_int8(linear.weight.detach().t(), axis=1)
        self.weight_int8 = torch.nn.Parameter(q.contiguous(),
                                              requires_grad=False)
        self.scales = torch.nn.Parameter(s, requires_grad=False)
        self.bias = linear.bias
        self.plain = False

    def forward(self, x):
        y = dequant_matmul_int8(x, self.weight_int8, self.scales,
                                plain=self.plain)
        return y if self.bias is None else y + self.bias

    def memory_bytes(self) -> int:
        return int(self.weight_int8.numel() + 4 * self.scales.numel())
