"""Grouped expert product (the MoE grouped GEMM): the CUDA kernel, its
plain version and the autograd Function.

Replaces ``paddle_tpu/ops/kernels/moe_gemm_pallas.py`` ``_grouped_call``
(:74; kernel body ``_kernel`` :34), reached through the custom_vjp
``grouped_matmul`` (:103-124). Source: ``paddle_tpu_torch/csrc/moe_gemm.cu``.

``out[e, c, :] = x[e, c, :] @ w[e]`` for ``c < counts[e]`` and zero for
``c >= counts[e]``, with ``x [E, C, H]``, ``w [E, H, F]`` and int32
``counts [E]``: f32 accumulation, one rounding to ``x.dtype``. Rows past
the count are zero whatever ``x`` holds there.

What bounds it on the H100: bytes at Qwen1.5-MoE's widths (the weight
stack, 346 MB at ``[60, 2048, 1408]``, is read once per call). The kernel
reads ``counts`` on the device, so nothing synchronises the host: its grid
covers the full capacity and each block skips a tile wholly past its
expert's count. It takes ``w`` either as ``[E, H, F]`` or as the
transpose of an ``[E, F, H]`` tensor (a ``w.transpose(1, 2)`` view), so the
backward's ``dx = g @ w[e]^T`` reads the forward's weight as it lies: JAX's
``jnp.swapaxes`` is free to XLA, a contiguous copy here would be 346 MB a
stack. Any ``C``, ``H % 8 == 0`` and ``F % 8 == 0``; the JAX kernel pads
``C`` to a multiple of 8 and slices (:80, :96).

The card path takes bf16 and raises for f32; the plain version takes both.
A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["grouped_matmul", "grouped_matmul_plain", "GroupedMatmulFunction",
           "live_rows"]

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _check(x, w, counts):
    if x.dim() != 3 or w.dim() != 3 or counts.dim() != 1:
        raise ValueError(f"grouped_matmul takes x [E, C, H], w [E, H, F] and "
                         f"counts [E], got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, {tuple(counts.shape)}")
    e, _, h = x.shape
    if w.shape[0] != e or w.shape[1] != h or counts.shape[0] != e:
        raise ValueError(f"grouped_matmul: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)} and counts {tuple(counts.shape)} "
                         f"do not fit")
    if not x.is_floating_point() or w.dtype != x.dtype:
        raise TypeError(f"grouped_matmul takes x and w of one floating dtype, "
                        f"got {x.dtype} and {w.dtype}")
    if counts.is_floating_point() or counts.is_complex():
        raise TypeError(f"counts must be integers, got {counts.dtype}")
    if w.device != x.device or counts.device != x.device:
        raise ValueError("grouped_matmul: operands on different devices")


def live_rows(counts, c):
    """``[E, C, 1]`` bool: row ``c`` of expert ``e`` is below ``counts[e]``."""
    return (torch.arange(c, device=counts.device)[None, :, None]
            < counts.reshape(-1, 1, 1))


def grouped_matmul_plain(x, w, counts):
    """The same function in plain PyTorch, as JAX's
    ``reference_grouped_matmul`` (:127-134) computes it: an f32
    contraction, one cast to ``x.dtype``, then rows at or past the count
    set to zero."""
    _check(x, w, counts)
    out = torch.bmm(x.float(), w.float()).to(x.dtype)
    return torch.where(live_rows(counts, x.shape[1]), out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def grouped_matmul(x, w, counts):
    """``out [E, C, F]``, as :func:`grouped_matmul_plain`. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel (bf16; ``H`` and
    ``F`` multiples of 8; ``w`` a contiguous ``[E, H, F]`` or the
    transpose of a contiguous ``[E, F, H]``) or raises."""
    _check(x, w, counts)
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w, counts)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_matmul: no kernel for device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"grouped_matmul kernel takes bf16, got {x.dtype}")
    e, c, h = x.shape
    f = w.shape[2]
    if h % 8 or f % 8:
        raise ValueError(f"grouped_matmul kernel needs H % 8 == 0 and "
                         f"F % 8 == 0, got H={h}, F={f}")
    if max(e, c, h, f) >= 2 ** 31:
        raise ValueError(f"grouped_matmul: dims {(e, c, h, f)} past the "
                         f"kernel's int range")
    w_nk = int(not w.is_contiguous())  # 1: w[e] is an [F, H] matrix's ^T
    if w_nk and not w.transpose(1, 2).is_contiguous():
        raise ValueError("grouped_matmul kernel takes w as a contiguous "
                         "[E, H, F] tensor or the transpose of a contiguous "
                         "[E, F, H] one")
    x = x.contiguous()
    counts = counts.to(torch.int32).contiguous()
    out = torch.empty(e, c, f, dtype=x.dtype, device=x.device)
    _build.require_aligned("grouped_matmul", x, w, out)
    fn = _build.function("moe_gemm", "ptt_moe_gemm", _ARGS)
    err = fn(x.data_ptr(), w.data_ptr(), counts.data_ptr(), out.data_ptr(),
             e, c, h, f, w_nk, _build.stream_of(x))
    _build.check(err, "grouped_matmul")
    grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0


class GroupedMatmulFunction(torch.autograd.Function):
    """The grouped product with JAX's custom_vjp (:103-124):
    ``dx = grouped(g, w^T, counts)`` through the same kernel (the
    transposed view, no copy), and ``dw = einsum("ech,ecf->ehf", x.f32,
    g_live.f32)`` cast to ``w.dtype``, the cotangent zeroed past the
    counts (a dense f32 product outside any kernel, as in JAX).
    ``apply(x, w, counts, plain)``; ``plain`` runs the plain forward and
    the plain dx."""

    @staticmethod
    def forward(ctx, x, w, counts, plain):
        ctx.save_for_backward(x, w, counts)
        ctx.plain = plain
        return (grouped_matmul_plain if plain else grouped_matmul)(
            x, w, counts)

    @staticmethod
    def backward(ctx, g):
        x, w, counts = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            fn = grouped_matmul_plain if ctx.plain else grouped_matmul
            dx = fn(g, w.transpose(1, 2), counts)
        if ctx.needs_input_grad[1]:
            g_live = torch.where(live_rows(counts, g.shape[1]), g.float(),
                                 torch.zeros((), device=g.device))
            dw = torch.bmm(x.float().transpose(1, 2), g_live).to(w.dtype)
        return dx, dw, None, None
