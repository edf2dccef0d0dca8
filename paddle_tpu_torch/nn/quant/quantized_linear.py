"""Weight-only quantized linear and LLM.int8 linear (counterpart of
``paddle_tpu/nn/quant/quantized_linear.py:25-234``).

The JAX package's layouts and signatures: weights ``[K, N]`` (``[in,
out]``) for the weight-only functions, ``[N, K]`` int8 for
``llm_int8_linear``. int4 stores two nibbles per byte in the halves
layout (byte ``j`` holds columns ``j`` and ``j + N'/2``; odd N carries one
zero pad column with a zero scale), the layout the int4 kernel reads
without a relayout. Byte for byte what the JAX package packs.

``plain=True`` runs the kernels' plain PyTorch versions on any device (a
check on the card holds the two paths against each other). The layer
classes are in ``quantization.wrapper`` and ``nn.quant.quant_layers``.
"""

from __future__ import annotations

import torch

from ...ops.kernels import a8w8_matmul as _a8
from ...ops.kernels import wo_matmul as _wo
from ...quantization.functional import (dequant_matmul_int4,
                                        dequant_matmul_int8,
                                        quantize_weight_int8)

__all__ = ["weight_quantize", "weight_dequantize", "weight_only_linear",
           "llm_int8_linear"]

_ALGOS = ("weight_only_int8", "weight_only_int4")


def _check_algo(algo):
    if algo not in _ALGOS:
        raise ValueError(f"algo must be one of {_ALGOS}, got {algo!r} "
                         f"(llm.int8 needs activation stats; use the "
                         f"quantization PTQ flow)")


def _pack_int4(q):
    """``[K, N]`` int4 values -> ``[K, ceil(N/2)]`` bytes, halves layout;
    an odd N is padded with one zero column first."""
    if q.shape[1] % 2:
        q = torch.nn.functional.pad(q, (0, 1))
    return _wo.pack_int4_halves(q)


def _unpack_int4(packed, n):
    """Inverse of :func:`_pack_int4` (drops the odd-N pad column)."""
    return _wo.unpack_int4_halves(packed)[:, :n]


@torch.no_grad()
def weight_quantize(x, algo="weight_only_int8", arch=None, group_size=-1):
    """``[K, N]`` float weight -> (quantized weight, f32 scales).

    int8: ``[K, N]`` int8. int4: ``[K, ceil(N/2)]`` packed bytes.
    ``group_size`` G > 0: scales ``[K/G, N]`` per (K-group, channel); -1:
    one scale per output channel ``[N]``. The arithmetic runs in the
    weight's dtype, as in the JAX package."""
    _check_algo(algo)
    gs = -1 if group_size is None else int(group_size)
    if gs != -1 and gs < 1:
        raise ValueError(f"group_size must be -1 (per-channel) or a "
                         f"positive divisor of K, got {group_size}")
    w = x.contiguous()
    bound = 127.0 if algo == "weight_only_int8" else 7.0
    if gs == -1:
        if algo == "weight_only_int8":
            return quantize_weight_int8(w, axis=1)
        s = w.abs().amax(dim=0).clamp_min(1e-9)
        q = torch.clamp(torch.round(w / s * bound), -bound, bound)
        return _pack_int4(q.to(torch.int8)), (s / bound).to(torch.float32)
    k, n = w.shape
    if k % gs:
        raise ValueError(f"group_size {gs} must divide K={k}")
    wg = w.reshape(k // gs, gs, n)
    s = wg.abs().amax(dim=1).clamp_min(1e-9)                 # [K/gs, N]
    q = torch.clamp(torch.round(wg / s[:, None] * bound), -bound, bound)
    q = q.reshape(k, n).to(torch.int8)
    scales = (s / bound).to(torch.float32)
    if algo == "weight_only_int4":
        return _pack_int4(q), scales
    return q, scales


@torch.no_grad()
def weight_dequantize(x, scale, algo="weight_only_int8", out_dtype="float32"):
    """Inverse transform (per-channel ``[N]`` or grouped ``[K/G, N]``
    scales) into ``out_dtype``, a name or a torch dtype."""
    _check_algo(algo)
    dt = getattr(torch, out_dtype) if isinstance(out_dtype, str) else out_dtype
    q, s = x, scale
    if s.dim() == 2:
        if algo == "weight_only_int4":
            q = _unpack_int4(q, s.shape[1])
        return _wo.dequant_grouped(q, s).to(dt)
    if algo == "weight_only_int4":
        q = _unpack_int4(q, s.shape[0])
    return q.to(dt) * s.to(dt)


def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype="int8", arch=None, group_size=-1,
                       plain=False):
    """``y = x @ dequant(weight) [+ bias]``.

    int8 runs the int8 kernel (per-channel or grouped); int4 runs the int4
    kernel on the packed bytes. Grouped int4 unpacks to dense int8 on every
    call and runs the grouped int8 kernel, as the JAX package does
    (``quantized_linear.py:129-135``)."""
    if weight_dtype not in ("int8", "int4"):
        raise ValueError(f"weight_dtype must be int8 or int4, "
                         f"got {weight_dtype!r}")
    if weight_scale is None:
        raise ValueError("weight_scale is required (from weight_quantize)")
    w, s = weight, weight_scale
    if s.dim() == 2:
        n = s.shape[1]
        if weight_dtype == "int4":
            w = _unpack_int4(w, n)
        y = dequant_matmul_int8(x, w, s, plain=plain)
    elif weight_dtype == "int4":
        n, half = s.shape[0], w.shape[1]
        if 2 * half != n:           # odd N carries one zero pad column
            s = torch.cat([s, s.new_zeros(2 * half - n)])
        y = dequant_matmul_int4(x, w, s, plain=plain)[..., :n]
    else:
        y = dequant_matmul_int8(x, w, s, plain=plain)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def llm_int8_linear(x, weight, bias=None, weight_scale=None, threshold=6.0,
                    plain=False):
    """LLM.int8 mixed-precision linear; ``weight`` int8 ``[N, K]``,
    ``weight_scale`` ``[N]``.

    Outlier feature columns (per-column absmax over the rows above
    ``threshold``) contract in f32 against the dequantized weight; the
    rest quantizes per row to int8. Two branches, as in the JAX package:
    where :func:`~paddle_tpu_torch.ops.kernels.a8w8_matmul.use_kernel`
    holds for ``(rows, K)`` and nothing needs a gradient, the dense part
    runs through the A8W8 kernel (``s = max(rowmax, 1e-6) / 127``,
    ``round(x / s)``); otherwise through the composite
    (``max(rowmax, 1e-9)``, ``round(x / rowmax * 127)``)."""
    k = x.shape[-1]
    x2 = x.reshape(-1, k)
    n = weight.shape[0]
    ws = weight_scale if weight_scale is not None else \
        torch.ones(n, dtype=torch.float32, device=x.device)
    tensors = [t for t in (x, weight, weight_scale, bias) if t is not None]
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in tensors)
    col_max = x2.abs().amax(dim=0)
    outlier = col_max > threshold                                # [K]
    x_dense = torch.where(outlier[None, :], torch.zeros_like(x2), x2)
    x_out = torch.where(outlier[None, :], x2, torch.zeros_like(x2))
    if not needs_grad and _a8.use_kernel(x2.shape[0], k):
        fn = _a8.a8w8_matmul_plain if plain else _a8.a8w8_matmul
        dense = fn(x_dense, weight, ws, layout="nk").float()
    else:
        row_scale = x_dense.abs().amax(dim=1).clamp_min(1e-9)
        q = torch.clamp(torch.round(x_dense / row_scale[:, None] * 127.0),
                        -127, 127).to(torch.int8)
        # integer contraction, exact in float64 on every device
        acc = (q.double() @ weight.double().t()).float()
        dense = acc * (row_scale[:, None] / 127.0) \
            * ws[None, :].to(torch.float32)
    w_fp = weight.float() * ws[:, None].float()
    out = dense + x_out.float() @ w_fp.t()
    out = out.to(x.dtype)
    if bias is not None:
        out = out + bias
    return out.reshape(*x.shape[:-1], n)
