"""MoE gates (counterpart of
``paddle_tpu/incubate/distributed/models/moe/gate.py`` :20-62).

A gate maps tokens ``[n, d_model]`` to expert scores ``[n, E]``; routing
and capacity live in :class:`MoELayer`. The score layer is a
``Linear(d_model, E)`` with a bias, its weight stored ``[E, d_model]`` as
``torch.nn.Linear`` keeps it (the JAX package stores ``[d_model, E]``). It
is drawn as JAX's ``Linear`` default draws it: XavierNormal, std
``sqrt(2 / (d_model + E))``, and a zero bias
(``paddle_tpu/nn/layers/common.py:25-35``,
``paddle_tpu/framework/parameter.py:60-67``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["BaseGate", "NaiveGate", "GShardGate", "SwitchGate"]


class BaseGate(nn.Module):
    def __init__(self, d_model, num_expert, world_size=1, top_k=2):
        super().__init__()
        self.d_model = d_model
        self.num_expert = num_expert
        self.world_size = world_size
        self.tot_expert = num_expert * world_size
        self.top_k = top_k
        self.loss = None

    def forward(self, x):
        raise NotImplementedError


class NaiveGate(BaseGate):
    """Plain linear top-k gate."""

    def __init__(self, d_model, num_expert, world_size=1, top_k=2):
        super().__init__(d_model, num_expert, world_size, top_k)
        self.gate = nn.Linear(d_model, self.tot_expert, bias=True)
        if self.gate.weight.device.type != "meta":
            self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """XavierNormal weight and zero bias, drawn from ``generator``
        (the default generator when None)."""
        std = math.sqrt(2.0 / (self.d_model + self.tot_expert))
        self.gate.weight.normal_(0.0, std, generator=generator)
        self.gate.bias.zero_()

    def forward(self, x):
        return self.gate(x)


class GShardGate(NaiveGate):
    """GShard gate: top-2, with the load-balance loss computed in
    :class:`MoELayer`."""

    def __init__(self, d_model, num_expert, world_size=1, top_k=2,
                 capacity=(1.2, 2.4), random_routing=True, group=None):
        super().__init__(d_model, num_expert, world_size, top_k)
        self.capacity = capacity


class SwitchGate(NaiveGate):
    """Switch-Transformer gate: always top-1."""

    def __init__(self, d_model, num_expert, world_size=1, top_k=1,
                 switch_eps=0.1, capacity=(1.2, 2.4), group=None):
        super().__init__(d_model, num_expert, world_size, top_k=1)
        self.switch_eps = switch_eps
