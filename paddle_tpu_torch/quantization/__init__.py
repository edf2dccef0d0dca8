"""Quantization primitives of the port (counterpart of
``paddle_tpu/quantization``). This slice carries the inference functions
the weight-only serving path needs; the PTQ/QAT flows and the gradients of
the quantized products come with the training slice."""

from .functional import (absmax_scale, dequant_matmul_int4,
                         dequant_matmul_int8, quantize_weight_int8)

__all__ = ["absmax_scale", "quantize_weight_int8", "dequant_matmul_int8",
           "dequant_matmul_int4"]
