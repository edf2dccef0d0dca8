"""Quantization primitives (counterpart of
``paddle_tpu/quantization/functional.py:37-81``).

``quantize_weight_int8`` keeps the JAX package's arithmetic and order:
``s = max(absmax over K, 1e-9)``, ``q = clip(round(w / s * 127), ±127)``
computed in the weight's own dtype, scales ``(s / 127)`` in f32.
``dequant_matmul_int8`` / ``dequant_matmul_int4`` run the weight-only
kernels (``ops/kernels/wo_matmul.py``): a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises. There is no quiet
fallback to a composite (the JAX package's ``_wo_dispatch`` has one).

These are inference functions in this slice: an input that requires a
gradient raises ``NotImplementedError``. The JAX package's VJP of the
weight-only product (``:109-190``) is ported with the training slice.
"""

from __future__ import annotations

import torch

from ..ops.kernels import wo_matmul as _wo

__all__ = ["absmax_scale", "quantize_weight_int8", "dequant_matmul_int8",
           "dequant_matmul_int4"]


def absmax_scale(x, axis=None):
    """Per-tensor (``axis=None``) or per-channel absmax scale."""
    if axis is None:
        return x.abs().amax()
    axes = tuple(i for i in range(x.dim()) if i != axis)
    return x.abs().amax(dim=axes)


def quantize_weight_int8(w, axis=1):
    """``[in, out]`` weight -> (int8 weight, f32 per-out-channel scales)."""
    bound = 127.0
    s = absmax_scale(w, axis=axis).clamp_min(1e-9)
    q = torch.clamp(torch.round(w / s * bound), -bound, bound).to(torch.int8)
    return q, (s / bound).to(torch.float32)


def _inference_only(what, *tensors):
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what}: gradients of the quantized products are not ported "
            f"yet (they come with the training slice); call it under "
            f"torch.no_grad() or on tensors that do not require grad")


def dequant_matmul_int8(x, w_int8, scales, plain=False):
    """``x @ dequant(w)``: int8 ``[in, out]`` weights with per-channel
    ``[out]`` or grouped ``[in/G, out]`` scales, through the weight-only
    kernel. ``plain=True`` runs the plain version on any device."""
    _inference_only("dequant_matmul_int8", x, scales)
    fn = _wo.wo_int8_matmul_plain if plain else _wo.wo_int8_matmul
    return fn(x, w_int8, scales)


def dequant_matmul_int4(x, w_packed, scales, plain=False):
    """``x @ dequant(int4-packed w) * scales``, halves layout, per-channel
    ``[N]`` scales only: grouped int4 goes through
    ``nn.quant.weight_only_linear``, which unpacks to dense int8 first."""
    if scales.dim() == 2:
        raise ValueError(
            "dequant_matmul_int4 takes per-channel [N] scales; for grouped "
            "[K/G, N] scales use nn.quant.weight_only_linear, which "
            "unpacks the int4 weight to dense int8 for the grouped path")
    _inference_only("dequant_matmul_int4", x, scales)
    fn = _wo.wo_int4_matmul_plain if plain else _wo.wo_int4_matmul
    return fn(x, w_packed, scales)
