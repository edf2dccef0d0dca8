"""Mixture of experts (counterpart of
``paddle_tpu/incubate/distributed/models/moe``): :class:`MoELayer`, its
gates and the MoE global-norm clip."""

from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate
from .grad_clip import ClipGradForMOEByGlobalNorm
from .moe_layer import MoELayer

__all__ = ["MoELayer", "NaiveGate", "GShardGate", "SwitchGate", "BaseGate",
           "ClipGradForMOEByGlobalNorm"]
