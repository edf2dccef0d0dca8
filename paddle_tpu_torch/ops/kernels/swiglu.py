"""SwiGLU gate ``silu(g) * u``, forward and backward: CUDA kernels, plain
versions and the autograd Function.

Replaces ``paddle_tpu/ops/kernels/swiglu_pallas.py`` ``_fused_fwd`` (:81;
kernel body :45-48) and ``_fused_bwd`` (:117; kernel body :58-66), reached
through the custom_vjp ``swiglu_fused`` (:162-179). Source:
``paddle_tpu_torch/csrc/swiglu.cu``.

What bounds both on the H100: bytes — the forward reads two tensors and
writes one, the backward reads three (``g``, ``u``, ``dy``) and writes two
(``dg``, ``du``), a few operations per element. Each kernel is a
grid-stride loop over 16-byte vectors (8 elements a thread per step), f32
inside; the backward recomputes the sigmoid from ``g``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["swiglu", "swiglu_plain", "swiglu_bwd", "swiglu_bwd_plain",
           "SwiGLUFunction"]

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_void_p]


def _check(g, u):
    if not g.is_floating_point() or u.dtype != g.dtype:
        raise TypeError(f"swiglu takes two floating tensors of one dtype, "
                        f"got {g.dtype} and {u.dtype}")
    if g.shape != u.shape or g.device != u.device:
        raise ValueError(f"swiglu: gate {tuple(g.shape)} and up "
                         f"{tuple(u.shape)} must match in shape and device")


def swiglu_plain(g, u):
    """The same function in plain PyTorch, f32 inside."""
    _check(g, u)
    gf = g.float()
    return (gf * torch.sigmoid(gf) * u.float()).to(g.dtype)


def swiglu(g, u):
    """``silu(g) * u``. A CPU tensor takes :func:`swiglu_plain`; a CUDA
    tensor launches the kernel (bf16, contiguous) or raises."""
    _check(g, u)
    if g.device.type == "cpu":
        return swiglu_plain(g, u)
    if g.device.type != "cuda":
        raise ValueError(f"swiglu: no kernel for device {g.device}")
    if g.dtype != torch.bfloat16:
        raise TypeError(f"swiglu kernel takes bf16, got {g.dtype}")
    if not (g.is_contiguous() and u.is_contiguous()):
        raise ValueError("swiglu kernel takes contiguous tensors")
    _build.require_aligned("swiglu", g, u)
    y = torch.empty_like(g)
    fn = _build.function("swiglu", "ptt_swiglu", _ARGS)
    err = fn(g.data_ptr(), u.data_ptr(), y.data_ptr(), g.numel(),
             _build.stream_of(g))
    _build.check(err, "swiglu")
    swiglu.launches += 1
    return y


swiglu.launches = 0


def swiglu_bwd_plain(g, u, dy):
    """``(dg, du)`` of ``silu(g) * u`` for the cotangent ``dy``, f32 inside:
    with ``sig = sigmoid(g)`` and ``s = g * sig``, ``dg = dy * u * sig *
    (1 + g - s)`` and ``du = dy * s``."""
    _check(g, u)
    _check(g, dy)
    gf = g.float()
    sig = torch.sigmoid(gf)
    s = gf * sig
    dyf = dy.float()
    dg = dyf * u.float() * sig * (1.0 + gf - s)
    return dg.to(g.dtype), (dyf * s).to(g.dtype)


def swiglu_bwd(g, u, dy):
    """``(dg, du)``, as :func:`swiglu_bwd_plain`. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel (bf16, contiguous) or
    raises."""
    _check(g, u)
    _check(g, dy)
    if g.device.type == "cpu":
        return swiglu_bwd_plain(g, u, dy)
    if g.device.type != "cuda":
        raise ValueError(f"swiglu backward: no kernel for device {g.device}")
    if g.dtype != torch.bfloat16:
        raise TypeError(f"swiglu backward kernel takes bf16, got {g.dtype}")
    if not (g.is_contiguous() and u.is_contiguous() and dy.is_contiguous()):
        raise ValueError("swiglu backward kernel takes contiguous tensors")
    _build.require_aligned("swiglu backward", g, u, dy)
    dg, du = torch.empty_like(g), torch.empty_like(g)
    fn = _build.function("swiglu", "ptt_swiglu_bwd", _BWD_ARGS)
    err = fn(g.data_ptr(), u.data_ptr(), dy.data_ptr(), dg.data_ptr(),
             du.data_ptr(), g.numel(), _build.stream_of(g))
    _build.check(err, "swiglu backward")
    swiglu_bwd.launches += 1
    return dg, du


swiglu_bwd.launches = 0


class SwiGLUFunction(torch.autograd.Function):
    """``silu(g) * u`` with its backward kernel (the custom_vjp of
    ``swiglu_fused``, which saves ``g`` and ``u``). ``apply(g, u, plain)``;
    ``plain`` runs the plain forward and the plain backward."""

    @staticmethod
    def forward(ctx, g, u, plain):
        ctx.save_for_backward(g, u)
        ctx.plain = plain
        return (swiglu_plain if plain else swiglu)(g, u)

    @staticmethod
    def backward(ctx, dy):
        g, u = ctx.saved_tensors
        bwd = swiglu_bwd_plain if ctx.plain else swiglu_bwd
        dg, du = bwd(g, u, dy.contiguous())
        return dg, du, None
