"""``nn.quant`` of the port (counterpart of ``paddle_tpu/nn/quant``): the
layer-level entry to quantization (``Stub``, the quantized layer
wrappers, ``quant_layers``) and the weight-only and LLM.int8 linear
functions."""

import torch

from ...quantization.functional import (absmax_scale, dequant_matmul_int8,
                                        fake_quant, quantize_weight_int8)
from ...quantization.quanters import FakeQuanterWithAbsMaxObserver
from ...quantization.wrapper import Int8WeightOnlyLinear, QuantedLinear
from . import quant_layers
from .quant_layers import (FakeQuantAbsMax, FakeQuantChannelWiseAbsMax,
                           FakeQuantMAOutputScaleLayer,
                           FakeQuantMovingAverageAbsMax, MAOutputScaleLayer,
                           MovingAverageAbsMaxScale,
                           QuantizedColumnParallelLinear, QuantizedConv2D,
                           QuantizedConv2DTranspose, QuantizedLinear,
                           QuantizedMatmul, QuantizedRowParallelLinear)
from .quantized_linear import (llm_int8_linear, weight_dequantize,
                               weight_only_linear, weight_quantize)

__all__ = ['Stub', 'QuantStub', 'weight_quantize', 'fake_quant',
           'llm_int8_linear', 'weight_dequantize', 'weight_only_linear',
           'absmax_scale', 'dequant_matmul_int8', 'quantize_weight_int8',
           'QuantedLinear', 'Int8WeightOnlyLinear',
           'FakeQuanterWithAbsMaxObserver', 'quant_layers']


class Stub(torch.nn.Module):
    """Observer insertion point: the identity in a float model; a QAT pass
    replaces it with the configured quanter."""

    def __init__(self, observer=None):
        super().__init__()
        self._observer = observer

    def forward(self, x):
        return x


QuantStub = Stub


def quanted_layer_types():
    """Module classes that quantization wrapping produces."""
    return [QuantedLinear, Int8WeightOnlyLinear]
