"""PTQ (counterpart of ``paddle_tpu/quantization/ptq.py``).

``quantize(model)`` puts an activation observer in front of each
configured ``torch.nn.Linear``; run calibration batches, then
``convert(model)`` replaces the observed layers with
:class:`Int8WeightOnlyLinear` (weights quantized per output channel,
activations left in float: the weight-only recipe).
"""

from __future__ import annotations

import copy

import torch

from .config import QuantConfig
from .observers import BaseObserver
from .wrapper import Int8WeightOnlyLinear

__all__ = ["PTQ"]


class _ObservedLinear(torch.nn.Module):
    def __init__(self, inner, observer):
        super().__init__()
        self.inner = inner
        self.observer = observer

    def forward(self, x):
        if self.observer is not None:
            self.observer.observe(x)
        return self.inner(x)


class PTQ:
    def __init__(self, config: QuantConfig):
        self._config = config

    def _wrap(self, layer: torch.nn.Module, prefix: str):
        for name, sub in list(layer.named_children()):
            full = f"{prefix}.{name}" if prefix else name
            cfg = self._config.config_for(sub, full)
            if isinstance(sub, torch.nn.Linear) and cfg is not None:
                obs = cfg.activation._instance(sub) \
                    if isinstance(cfg.activation, BaseObserver) else None
                setattr(layer, name, _ObservedLinear(sub, obs))
            else:
                self._wrap(sub, full)
        return layer

    def quantize(self, model, inplace: bool = False):
        target = model if inplace else copy.deepcopy(model)
        return self._wrap(target, "")

    def convert(self, model, inplace: bool = False):
        target = model if inplace else copy.deepcopy(model)

        def conv(layer):
            for name, sub in list(layer.named_children()):
                if isinstance(sub, _ObservedLinear):
                    setattr(layer, name, Int8WeightOnlyLinear(sub.inner))
                else:
                    conv(sub)
        conv(target)
        return target
