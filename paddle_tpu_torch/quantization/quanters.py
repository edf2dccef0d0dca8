"""QAT quanters (counterpart of ``paddle_tpu/quantization/quanters.py``).

A quanter is a module inserted into the quantized model: it tracks a
moving-average absmax scale in a device buffer and applies fake
quantization with the straight-through estimator every forward. The
forward reads nothing back to the host; :meth:`scale` does.
"""

from __future__ import annotations

import sys

import torch

from .functional import fake_quant_array

__all__ = ["BaseQuanter", "FakeQuanterWithAbsMaxObserver", "quanter"]


class BaseQuanter(torch.nn.Module):
    """Abstract quanter: the forward gives the fake-quantized tensor;
    ``scales()`` / ``zero_points()`` expose the learned parameters."""

    def scales(self):
        raise NotImplementedError

    def zero_points(self):
        raise NotImplementedError


class FakeQuanterWithAbsMaxObserver(BaseQuanter):
    def __init__(self, moving_rate=0.9, bit_length=8, dtype="float32",
                 name=None):
        super().__init__()
        self.moving_rate = moving_rate
        self.bit_length = bit_length
        self.register_buffer("_scale", torch.zeros((), dtype=torch.float32))
        self.register_buffer("_inited", torch.zeros((), dtype=torch.float32))

    def _instance(self, layer):
        return FakeQuanterWithAbsMaxObserver(self.moving_rate,
                                             self.bit_length)

    def scales(self):
        return self._scale

    def zero_points(self):
        return None  # absmax quantization is symmetric

    def forward(self, x):
        if self.training:
            mr = self.moving_rate
            with torch.no_grad():
                cur = x.abs().amax().float()
                new = torch.where(self._inited > 0,
                                  mr * self._scale + (1 - mr) * cur, cur)
                self._scale.copy_(new)
                self._inited.fill_(1.0)
        return fake_quant_array(x, self._scale.clamp_min(1e-9),
                                self.bit_length)

    def scale(self):
        return float(self._scale)


def quanter(class_name):
    """Factory-declaration decorator: registers ``class_name`` in
    ``paddle_tpu_torch.quantization`` as a factory that constructs the
    decorated quanter with the arguments it was given."""
    def deco(cls):
        class _Factory:
            def __init__(self, *args, **kwargs):
                self._args, self._kwargs = args, kwargs

            def _instance(self, layer=None):
                return cls(*self._args, **self._kwargs)

            def __call__(self, *a, **kw):
                return cls(*self._args, **self._kwargs)

        _Factory.__name__ = class_name
        setattr(sys.modules[__package__], class_name, _Factory)
        return cls
    return deco
