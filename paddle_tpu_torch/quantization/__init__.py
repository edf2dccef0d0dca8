"""Quantization of the port (counterpart of ``paddle_tpu/quantization``).

Fake quantization is plain tensor code with a straight-through estimator,
so QAT trains through the same kernels as float training. PTQ observers
collect ranges on calibration batches and ``convert`` bakes them in:
``Int8WeightOnlyLinear`` keeps int8 weights and per-channel scales and runs
the weight-only kernels (``ops/kernels/wo_matmul.py``), forward and, for
the activations' gradient, the JAX package's VJP.
"""

from .config import QuantConfig, SingleLayerConfig
from .functional import fake_quant, quantize_weight_int8
from .observers import (AbsmaxObserver, BaseObserver,
                        MovingAverageMinMaxObserver)
from .ptq import PTQ
from .qat import QAT
from .quanters import BaseQuanter, FakeQuanterWithAbsMaxObserver, quanter
from .wrapper import Int8WeightOnlyLinear, QuantedLinear

__all__ = [
    "QuantConfig", "SingleLayerConfig", "AbsmaxObserver",
    "MovingAverageMinMaxObserver", "FakeQuanterWithAbsMaxObserver", "QAT",
    "PTQ", "QuantedLinear", "Int8WeightOnlyLinear", "fake_quant",
    "quantize_weight_int8", "BaseQuanter", "BaseObserver", "quanter",
]
