"""``incubate.nn`` of the port (counterpart of ``paddle_tpu/incubate/nn``):
the fused layers and functions."""

from . import functional
from .functional import memory_efficient_attention
from .layer import (FusedBiasDropoutResidualLayerNorm, FusedDropoutAdd,
                    FusedEcMoe, FusedFeedForward, FusedLinear,
                    FusedMultiHeadAttention, FusedMultiTransformer,
                    FusedTransformerEncoderLayer)

__all__ = ["functional", "FusedBiasDropoutResidualLayerNorm",
           "FusedDropoutAdd", "FusedEcMoe", "FusedFeedForward", "FusedLinear",
           "FusedMultiHeadAttention", "FusedMultiTransformer",
           "FusedTransformerEncoderLayer", "memory_efficient_attention"]
