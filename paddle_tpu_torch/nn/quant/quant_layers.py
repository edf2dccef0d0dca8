"""QAT fake-quant layers (counterpart of
``paddle_tpu/nn/quant/quant_layers.py``).

Every quant-dequant runs with the straight-through estimator
(``quantization.functional.fake_quant_array``), so these layers train as
any module does; the moving-average scales live in device buffers and
update in place, reading nothing back to the host.

The wrapped layers are torch's: ``QuantizedLinear`` wraps a
``torch.nn.Linear`` (weight ``[out, in]``), the conv wrappers a
``torch.nn.Conv2d`` / ``ConvTranspose2d`` (torch's weight layouts are
Paddle's). ``weight_quant_axis`` names an axis of the wrapped layer's own
weight. The conv bodies are ``torch.nn.functional.conv2d`` /
``conv_transpose2d``, as the JAX layers' are ``lax`` convolutions.
``QuantizedColumnParallelLinear`` / ``QuantizedRowParallelLinear`` run the
wrapped layer's own forward with the fake-quantized weight, as the JAX
layers do; the port's model-parallel layers exist at one rank only, so a
layer sharded over more than one rank raises.
"""

from __future__ import annotations

import torch

from ...quantization.functional import absmax_scale, fake_quant_array

__all__ = [
    "FakeQuantAbsMax", "FakeQuantMovingAverageAbsMax",
    "FakeQuantChannelWiseAbsMax", "FakeQuantMAOutputScaleLayer",
    "MAOutputScaleLayer", "MovingAverageAbsMaxScale", "QuantizedConv2D",
    "QuantizedConv2DTranspose", "QuantizedLinear", "QuantizedMatmul",
    "QuantizedColumnParallelLinear", "QuantizedRowParallelLinear",
]


class FakeQuantAbsMax(torch.nn.Module):
    """Per-tensor absmax quant-dequant."""

    def __init__(self, name=None, quant_bits=8, dtype="float32",
                 quant_on_weight=False, reduce_type=None):
        super().__init__()
        self._quant_bits = quant_bits

    def forward(self, x):
        return fake_quant_array(x, absmax_scale(x.detach()),
                                self._quant_bits)


class FakeQuantChannelWiseAbsMax(torch.nn.Module):
    """Per-channel absmax quant-dequant along ``quant_axis``."""

    def __init__(self, name=None, channel_num=None, quant_bits=8,
                 quant_axis=0, dtype="float32", quant_on_weight=False,
                 reduce_type=None):
        super().__init__()
        self._quant_bits = quant_bits
        self._quant_axis = quant_axis

    def forward(self, x):
        ax = self._quant_axis
        shape = [1] * x.dim()
        shape[ax] = -1
        scale = absmax_scale(x.detach(), axis=ax).reshape(shape)
        return fake_quant_array(x, scale, self._quant_bits)


class _MovingScale(torch.nn.Module):
    """Moving-average absmax scale: ``(r * accum + max|x|) / (r * state +
    1)``, both terms in f32 device buffers."""

    def __init__(self, moving_rate=0.9):
        super().__init__()
        self._moving_rate = moving_rate
        self.register_buffer("_accum", torch.zeros((), dtype=torch.float32))
        self.register_buffer("_state", torch.zeros((), dtype=torch.float32))

    def update(self, x):
        r = self._moving_rate
        with torch.no_grad():
            if self.training:
                cur = x.abs().amax().float()
                self._accum.copy_(r * self._accum + cur)
                self._state.copy_(r * self._state + 1.0)
            return torch.where(self._state > 0,
                               self._accum / self._state.clamp_min(1e-9),
                               torch.ones_like(self._accum))

    @property
    def scale(self):
        return self._accum / self._state.clamp_min(1e-9)


class FakeQuantMovingAverageAbsMax(torch.nn.Module):
    def __init__(self, name=None, moving_rate=0.9, quant_bits=8,
                 dtype="float32", reduce_type=None):
        super().__init__()
        self._quant_bits = quant_bits
        self._ma = _MovingScale(moving_rate)

    def forward(self, x):
        return fake_quant_array(x, self._ma.update(x), self._quant_bits)


class MovingAverageAbsMaxScale(torch.nn.Module):
    """Keeps the output scale only; x passes through."""

    def __init__(self, name=None, moving_rate=0.9, dtype="float32",
                 reduce_type=None):
        super().__init__()
        self._ma = _MovingScale(moving_rate)

    @property
    def scale(self):
        return self._ma.scale

    def forward(self, x):
        self._ma.update(x)
        return x


class MAOutputScaleLayer(torch.nn.Module):
    """Wrap a layer, tracking its output scale."""

    def __init__(self, layer=None, moving_rate=0.9, name=None,
                 dtype="float32", reduce_type=None):
        super().__init__()
        self._layer = layer
        self._ma_output_scale = MovingAverageAbsMaxScale(
            name, moving_rate, dtype)

    def forward(self, *args, **kwargs):
        out = self._layer(*args, **kwargs)
        if isinstance(out, (list, tuple)):
            return out
        return self._ma_output_scale(out)


class FakeQuantMAOutputScaleLayer(torch.nn.Module):
    """Wrap a layer, fake-quantizing its output with a moving-average
    scale."""

    def __init__(self, layer=None, weight_bits=8, activation_bits=8,
                 moving_rate=0.9, name=None, reduce_type=None, *args,
                 **kwargs):
        super().__init__()
        self._layer = layer
        self._fake_quant_output = FakeQuantMovingAverageAbsMax(
            name, moving_rate, quant_bits=activation_bits)

    def forward(self, *args, **kwargs):
        out = self._layer(*args, **kwargs)
        if isinstance(out, (list, tuple)):
            return out
        return self._fake_quant_output(out)


def _make_weight_quanter(weight_quantize_type, weight_bits, quant_axis=0):
    if weight_quantize_type == "channel_wise_abs_max":
        return FakeQuantChannelWiseAbsMax(quant_bits=weight_bits,
                                          quant_axis=quant_axis)
    if weight_quantize_type == "moving_average_abs_max":
        return FakeQuantMovingAverageAbsMax(quant_bits=weight_bits)
    return FakeQuantAbsMax(quant_bits=weight_bits, quant_on_weight=True)


class _QuantizedWrapper(torch.nn.Module):
    """Fake-quant the activation and the weight, then run the float
    layer's body on the quantized pair."""

    def __init__(self, layer, weight_bits=8, activation_bits=8,
                 moving_rate=0.9, weight_quantize_type="abs_max",
                 activation_quantize_type="moving_average_abs_max",
                 weight_quant_axis=0, **kwargs):
        super().__init__()
        self._layer = layer
        if activation_quantize_type == "moving_average_abs_max":
            self._fake_quant_input = FakeQuantMovingAverageAbsMax(
                moving_rate=moving_rate, quant_bits=activation_bits)
        else:
            self._fake_quant_input = FakeQuantAbsMax(
                quant_bits=activation_bits)
        self._fake_quant_weight = _make_weight_quanter(
            weight_quantize_type, weight_bits, weight_quant_axis)
        dev = getattr(layer, "weight", None)
        if dev is not None:
            self.to(dev.device)

    @property
    def weight(self):
        return self._layer.weight

    @property
    def bias(self):
        return getattr(self._layer, "bias", None)

    def _quant_pair(self, x):
        return self._fake_quant_input(x), self._fake_quant_weight(self.weight)


class QuantizedConv2D(_QuantizedWrapper):
    def forward(self, x):
        qx, qw = self._quant_pair(x)
        lay = self._layer
        return torch.nn.functional.conv2d(
            qx, qw, self.bias, stride=lay.stride, padding=lay.padding,
            dilation=lay.dilation, groups=lay.groups)


class QuantizedConv2DTranspose(_QuantizedWrapper):
    def forward(self, x, output_size=None):
        qx, qw = self._quant_pair(x)
        lay = self._layer
        out_pad = lay.output_padding if output_size is None else \
            lay._output_padding(x, output_size, lay.stride, lay.padding,
                                lay.kernel_size, 2, lay.dilation)
        return torch.nn.functional.conv_transpose2d(
            qx, qw, self.bias, stride=lay.stride, padding=lay.padding,
            output_padding=out_pad, groups=lay.groups, dilation=lay.dilation)


class QuantizedLinear(_QuantizedWrapper):
    def forward(self, x):
        qx, qw = self._quant_pair(x)
        return torch.nn.functional.linear(qx, qw, self.bias)


class QuantizedMatmul(torch.nn.Module):
    """Fake-quant both operands of a matmul."""

    def __init__(self, layer=None, weight_bits=8, activation_bits=8,
                 moving_rate=0.9, **kwargs):
        super().__init__()
        self._fake_quant_x = FakeQuantMovingAverageAbsMax(
            moving_rate=moving_rate, quant_bits=activation_bits)
        self._fake_quant_y = FakeQuantMovingAverageAbsMax(
            moving_rate=moving_rate, quant_bits=activation_bits)

    def forward(self, x, y, transpose_x=False, transpose_y=False,
                name=None):
        qx, qy = self._fake_quant_x(x), self._fake_quant_y(y)
        if transpose_x:
            qx = qx.transpose(-1, -2)
        if transpose_y:
            qy = qy.transpose(-1, -2)
        return torch.matmul(qx, qy)


class QuantizedColumnParallelLinear(_QuantizedWrapper):
    """Quantize, then run the wrapped layer's own forward with the
    fake-quantized weight in place of its own."""

    def __init__(self, layer, *args, **kwargs):
        world = getattr(layer, "world_size", 1)
        if world not in (None, 1):
            raise NotImplementedError(
                f"{type(self).__name__}: a layer sharded over {world} "
                f"ranks needs a device mesh, which the port does not have "
                f"yet")
        super().__init__(layer, *args, **kwargs)

    def forward(self, x):
        qx, qw = self._quant_pair(x)
        return torch.func.functional_call(self._layer, {"weight": qw}, (qx,))


class QuantizedRowParallelLinear(QuantizedColumnParallelLinear):
    pass
