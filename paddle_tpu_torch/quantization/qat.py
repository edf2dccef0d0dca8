"""QAT (counterpart of ``paddle_tpu/quantization/qat.py``).

``quantize(model)`` walks the module tree, replacing each configured
``torch.nn.Linear`` with a :class:`QuantedLinear` carrying fresh quanter
instances; the result trains as any module does.
"""

from __future__ import annotations

import copy

import torch

from .config import QuantConfig
from .wrapper import QuantedLinear

__all__ = ["QAT"]


class QAT:
    def __init__(self, config: QuantConfig):
        self._config = config

    def _wrap(self, layer: torch.nn.Module, prefix: str):
        for name, sub in list(layer.named_children()):
            full = f"{prefix}.{name}" if prefix else name
            cfg = self._config.config_for(sub, full)
            if isinstance(sub, QuantedLinear):
                continue  # already quantized: never recurse into or rewrap
            if isinstance(sub, torch.nn.Linear) and cfg is not None:
                act_q = cfg.activation._instance(sub) \
                    if cfg.activation is not None else None
                w_q = cfg.weight._instance(sub) \
                    if cfg.weight is not None else None
                setattr(layer, name, QuantedLinear(sub, act_q, w_q)
                        .to(sub.weight.device))
            else:
                self._wrap(sub, full)
        return layer

    def quantize(self, model, inplace: bool = False):
        target = model if inplace else copy.deepcopy(model)
        return self._wrap(target, "")

    def convert(self, model, inplace: bool = False):
        """Strip the quanters for deployment: the plain Linears come back
        (weights stay float; ``PTQ.convert`` gives int8 weights)."""
        target = model if inplace else copy.deepcopy(model)

        def strip(layer):
            for name, sub in list(layer.named_children()):
                if isinstance(sub, QuantedLinear):
                    setattr(layer, name, sub.inner)
                else:
                    strip(sub)
        strip(target)
        return target
