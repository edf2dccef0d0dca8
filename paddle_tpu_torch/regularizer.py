"""Weight-decay regularizers (counterpart of ``paddle_tpu/regularizer.py``
``L1Decay`` :22 and ``L2Decay`` :33).

An optimizer given one as ``weight_decay`` adds the decay to each
gradient before its update (coupled decay); a bare float ``weight_decay``
means ``L2Decay`` of that coefficient. Plain tensor code on the gradient's
device.
"""

from __future__ import annotations

import torch

__all__ = ["L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    _coeff = 0.0

    def _apply(self, param, grad):
        raise NotImplementedError


class L1Decay(WeightDecayRegularizer):
    """``grad + coeff * sign(param)``."""

    def __init__(self, coeff: float = 0.0):
        self._coeff = float(coeff)

    def _apply(self, param, grad):
        return grad + self._coeff * torch.sign(param).to(grad.dtype)

    def __repr__(self):
        return f"L1Decay({self._coeff})"


class L2Decay(WeightDecayRegularizer):
    """``grad + coeff * param``."""

    def __init__(self, coeff: float = 0.0):
        self._coeff = float(coeff)

    def _apply(self, param, grad):
        return grad + self._coeff * param.to(grad.dtype)

    def __repr__(self):
        return f"L2Decay({self._coeff})"
