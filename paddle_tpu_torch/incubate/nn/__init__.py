"""``incubate.nn`` of the port (counterpart of ``paddle_tpu/incubate/nn``):
the fused layers and functions whose kernels are ported."""

from . import functional
from .layer import (FusedBiasDropoutResidualLayerNorm, FusedDropoutAdd,
                    FusedLinear)

__all__ = ["functional", "FusedBiasDropoutResidualLayerNorm",
           "FusedDropoutAdd", "FusedLinear"]
