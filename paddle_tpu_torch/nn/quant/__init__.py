"""``nn.quant`` of the port (counterpart of ``paddle_tpu/nn/quant``): the
weight-only linear and LLM.int8 functions; the layer classes come with the
quantization APIs."""

from ...quantization.functional import (absmax_scale, dequant_matmul_int8,
                                        quantize_weight_int8)
from .quantized_linear import (llm_int8_linear, weight_dequantize,
                               weight_only_linear, weight_quantize)

__all__ = ["weight_quantize", "weight_dequantize", "weight_only_linear",
           "llm_int8_linear", "absmax_scale", "dequant_matmul_int8",
           "quantize_weight_int8"]
