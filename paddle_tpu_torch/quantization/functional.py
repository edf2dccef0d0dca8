"""Quantization primitives (counterpart of
``paddle_tpu/quantization/functional.py``).

``fake_quant`` / ``fake_quant_array`` are symmetric fake quantization with
the straight-through estimator (``x + (q - x).detach()``: forward ``q``,
backward identity), plain tensor code as in the JAX package, which
computes them outside any kernel.

``quantize_weight_int8`` keeps the JAX package's arithmetic and order:
``s = max(absmax over K, 1e-9)``, ``q = clip(round(w / s * 127), ±127)``
computed in the weight's own dtype, scales ``(s / 127)`` in f32.
``dequant_matmul_int8`` / ``dequant_matmul_int4`` run the weight-only
kernels (``ops/kernels/wo_matmul.py``) forward: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises. There is no
quiet fallback to a composite (the JAX package's ``_wo_dispatch`` has
one).

Their gradients are the JAX package's VJP (``_wo_bwd_math``, ``:109-137``),
a :class:`torch.autograd.Function` around the kernel forward: ``dx`` is a
plain ``torch.matmul`` against the dequantised weight (a transient dense
``[K, N]`` copy in the gradient's dtype, f32 for grouped scales), ``ds``
(with the f32 recompute ``u = x @ w`` for per-channel scales) only when
the scales require a gradient; the integer weight gets none.
"""

from __future__ import annotations

import torch

from ..ops.kernels import wo_matmul as _wo

__all__ = ["fake_quant", "fake_quant_array", "absmax_scale",
           "quantize_weight_int8", "dequant_matmul_int8",
           "dequant_matmul_int4"]


def fake_quant_array(x, scale, bit_length=8):
    """Symmetric fake quantization of ``x`` by ``scale`` (a number or a
    tensor that broadcasts to ``x``), with the straight-through estimator.

    The arithmetic runs in JAX's promoted dtype (a Python number is weak:
    ``x``'s dtype; a tensor scale: ``promote_types(x, scale)``), then
    ``q`` is cast to ``x``'s dtype."""
    bound = 2 ** (bit_length - 1) - 1
    if isinstance(scale, torch.Tensor):
        dt = torch.promote_types(x.dtype, scale.dtype)
        s = scale.detach().to(dt).clamp_min(1e-9)
    else:
        dt, s = x.dtype, max(float(scale), 1e-9)
    xd = x.detach().to(dt)
    q = torch.clamp(torch.round(xd / s * bound), -bound, bound) * s / bound
    return x + (q.to(x.dtype) - x).detach()


def fake_quant(x, scale, bit_length=8):
    """Tensor-level fake quant (the JAX package's ``fake_quantize`` op)."""
    return fake_quant_array(x, scale, bit_length)


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


def _wo_bwd(x, w_dense, scales, g, x_dtype, need_dx, need_ds):
    """The JAX package's weight-only VJP (``_wo_bwd_math``); ``x`` is read
    only for ``ds`` (None when ``need_ds`` is false), ``dx`` is returned
    in ``x_dtype``.

    Per-channel (s ``[N]``): ``y = (x @ w) * s``, ``dx = (g * s) @ w^T``
    in g's dtype; ``ds = sum(g * u)`` with ``u = x @ w`` recomputed in f32
    (dividing the saved output by the scales would be wrong at a zero
    scale). Grouped (s ``[K/G, N]``): ``y = x @ (w * s)``, ``dx = g @ (w *
    s)^T`` in f32; ``ds[kg, n] = sum over the group's k of (x^T g)[k, n] *
    w[k, n]``."""
    dx = ds = None
    if scales.dim() == 2:
        k, n = w_dense.shape
        grp = k // scales.shape[0]
        if need_dx:
            wd = _wo.dequant_grouped(w_dense, scales)          # f32 [K, N]
            dx = torch.matmul(g.float(), wd.t()).to(x_dtype)
        if need_ds:
            xtg = torch.matmul(x.reshape(-1, k).float().t(),
                               g.reshape(-1, n).float())       # [K, N]
            ds = (xtg * w_dense.float()).reshape(k // grp, grp, n).sum(1) \
                .to(scales.dtype)
        return dx, ds
    if need_dx:
        gs = g * scales.to(g.dtype)
        dx = torch.matmul(gs, w_dense.to(g.dtype).t()).to(x_dtype)
    if need_ds:
        u = torch.matmul(x.float(), w_dense.float())
        ds = (g.float() * u).reshape(-1, u.shape[-1]).sum(0).to(scales.dtype)
    return dx, ds


class _WeightOnlyMatmul(torch.autograd.Function):
    """``x @ dequant(w) * s`` forward through the weight-only kernel
    (int8, or packed int4 when ``int4``), the JAX VJP backward."""

    @staticmethod
    def forward(ctx, x, w, scales, int4, plain):
        if int4:
            fn = _wo.wo_int4_matmul_plain if plain else _wo.wo_int4_matmul
        else:
            fn = _wo.wo_int8_matmul_plain if plain else _wo.wo_int8_matmul
        ctx.int4, ctx.x_dtype = int4, x.dtype
        # x is read only by ds: frozen scales keep no activation alive
        ctx.save_for_backward(x if ctx.needs_input_grad[2] else None, w,
                              scales)
        return fn(x, w, scales)

    @staticmethod
    def backward(ctx, g):
        x, w, scales = ctx.saved_tensors
        need_dx, _, need_ds = ctx.needs_input_grad[:3]
        w_dense = _wo.unpack_int4_halves(w) if ctx.int4 else w
        dx, ds = _wo_bwd(x, w_dense, scales, g, ctx.x_dtype, need_dx,
                         need_ds)
        return dx, None, ds, None, None


def _needs_grad(*tensors):
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in tensors)


def dequant_matmul_int8(x, w_int8, scales, plain=False):
    """``x @ dequant(w)``: int8 ``[in, out]`` weights with per-channel
    ``[out]`` or grouped ``[in/G, out]`` scales, through the weight-only
    kernel; differentiable in ``x`` and ``scales`` (JAX's VJP).
    ``plain=True`` runs the plain version on any device."""
    if _needs_grad(x, scales):
        return _WeightOnlyMatmul.apply(x, w_int8, scales, False, plain)
    fn = _wo.wo_int8_matmul_plain if plain else _wo.wo_int8_matmul
    return fn(x, w_int8, scales)


def dequant_matmul_int4(x, w_packed, scales, plain=False):
    """``x @ dequant(int4-packed w) * scales``, halves layout, per-channel
    ``[N]`` scales only: grouped int4 goes through
    ``nn.quant.weight_only_linear``, which unpacks to dense int8 first.
    Differentiable in ``x`` and ``scales`` (JAX's VJP on the unpacked
    weight)."""
    if scales.dim() == 2:
        raise ValueError(
            "dequant_matmul_int4 takes per-channel [N] scales; for grouped "
            "[K/G, N] scales use nn.quant.weight_only_linear, which "
            "unpacks the int4 weight to dense int8 for the grouped path")
    if _needs_grad(x, scales):
        return _WeightOnlyMatmul.apply(x, w_packed, scales, True, plain)
    fn = _wo.wo_int4_matmul_plain if plain else _wo.wo_int4_matmul
    return fn(x, w_packed, scales)
