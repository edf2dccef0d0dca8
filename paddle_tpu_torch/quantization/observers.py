"""PTQ observers (counterpart of ``paddle_tpu/quantization/observers.py``).

Observers watch activations during calibration and produce the scale
used at convert time. Each observation reads one number back to the host,
as the JAX observers do.
"""

from __future__ import annotations

import torch

__all__ = ["BaseObserver", "AbsmaxObserver", "MovingAverageMinMaxObserver"]


def _absmax(x) -> float:
    return float(x.detach().abs().amax())


class BaseObserver(torch.nn.Module):
    def __init__(self, bit_length=8):
        super().__init__()
        self.bit_length = bit_length

    def scale(self) -> float:
        raise NotImplementedError

    def forward(self, x):
        self.observe(x)
        return x

    def observe(self, x):
        raise NotImplementedError

    def _instance(self, layer):
        """An observer doubles as its own factory: a fresh one of its
        type for each observed layer."""
        return type(self)(bit_length=self.bit_length)


class AbsmaxObserver(BaseObserver):
    """Running max of ``|x|``."""

    def __init__(self, bit_length=8, quant_bits=None):
        super().__init__(bit_length=quant_bits or bit_length)
        self._max = 0.0

    def observe(self, x):
        self._max = max(self._max, _absmax(x))

    def scale(self):
        return self._max if self._max > 0 else 1e-9


class MovingAverageMinMaxObserver(BaseObserver):
    """EMA of the per-batch absmax."""

    def __init__(self, moving_rate=0.9, bit_length=8):
        super().__init__(bit_length=bit_length)
        self.moving_rate = moving_rate
        self._state = None

    def observe(self, x):
        cur = _absmax(x)
        if self._state is None:
            self._state = cur
        else:
            self._state = self.moving_rate * self._state + \
                (1 - self.moving_rate) * cur

    def scale(self):
        return self._state if self._state else 1e-9
