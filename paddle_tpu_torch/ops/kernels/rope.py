"""Rotate-half rotary position embedding: CUDA kernel, plain version and
the autograd Function.

Replaces ``paddle_tpu/ops/kernels/rope_pallas.py`` ``_rope_call`` (:48;
kernel body :28-36), reached through the custom_vjp ``rope_apply``
(:86-103). Source: ``paddle_tpu_torch/csrc/rope.cu``. Rotation is
orthogonal, so the backward is the same kernel with ``-sin``
(:class:`RoPEFunction`); the tables take no gradient.

What bounds it on the H100: bytes — ``x`` read once and written once, the
f32 cos/sin rows read once per token. The kernel gives each token one
block, so its cos/sin rows serve every head, and rotates neighbouring
pairs through 4-byte bf16x2 accesses.

Tables: ``cos``/``sin`` are f32 ``[S, D]`` (one row per position, shared by
the batch, as the TPU kernel takes them) or ``[B*S, D]`` (one row per
token). The second form serves decode, where each batch row sits at its
own position; the JAX dispatch falls back to its composite there
(``paddle_tpu/nn/functional/__init__.py:518-526``), which computes the
same function.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["rope_apply", "rope_plain", "RoPEFunction"]

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _check(x, cos, sin):
    if not x.is_floating_point():
        raise TypeError(f"rope takes a floating tensor, got {x.dtype}")
    if x.dim() != 4 or x.shape[-1] % 2:
        raise ValueError(f"rope takes x [B, S, H, D] with D even, got "
                         f"{tuple(x.shape)}")
    b, s, _, d = x.shape
    for t in (cos, sin):
        if t.dim() != 2 or t.shape[1] != d or t.shape[0] not in (s, b * s):
            raise ValueError(f"rope tables must be [S, D] or [B*S, D] for x "
                             f"{tuple(x.shape)}, got {tuple(t.shape)}")
        if t.dtype != torch.float32 or t.device != x.device:
            raise ValueError("rope tables must be f32 on x's device")


def rope_plain(x, cos, sin):
    """The same function in plain PyTorch, f32 inside, cast once."""
    _check(x, cos, sin)
    b, s, _, d = x.shape
    shape = (1, s, 1, d) if cos.shape[0] == s else (b, s, 1, d)
    c, sn = cos.reshape(shape), sin.reshape(shape)
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    rot = torch.cat([-x2, x1], dim=-1)
    return (xf * c + rot * sn).to(x.dtype)


def rope_apply(x, cos, sin):
    """RoPE on ``x [B, S, H, D]``. A CPU tensor takes :func:`rope_plain`; a
    CUDA tensor launches the kernel (bf16, contiguous, D % 4 == 0) or
    raises."""
    _check(x, cos, sin)
    if x.device.type == "cpu":
        return rope_plain(x, cos, sin)
    if x.device.type != "cuda":
        raise ValueError(f"rope: no kernel for device {x.device}")
    b, s, h, d = x.shape
    if x.dtype != torch.bfloat16:
        raise TypeError(f"rope kernel takes bf16, got {x.dtype}")
    if d % 4:
        raise ValueError(f"rope kernel needs D % 4 == 0, got {d}")
    if not (x.is_contiguous() and cos.is_contiguous() and sin.is_contiguous()):
        raise ValueError("rope kernel takes contiguous tensors")
    _build.require_aligned("rope", x, cos, sin)
    out = torch.empty_like(x)
    fn = _build.function("rope", "ptt_rope", _ARGS)
    err = fn(x.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(),
             b * s, h, d, s, int(cos.shape[0] == b * s), _build.stream_of(x))
    _build.check(err, "rope")
    rope_apply.launches += 1
    return out


rope_apply.launches = 0


class RoPEFunction(torch.autograd.Function):
    """RoPE with its adjoint, rotation by ``-theta``: ``apply(x, cos, sin,
    plain)``; ``plain`` runs the plain version both ways."""

    @staticmethod
    def forward(ctx, x, cos, sin, plain):
        ctx.save_for_backward(cos, sin)
        ctx.plain = plain
        return (rope_plain if plain else rope_apply)(x, cos, sin)

    @staticmethod
    def backward(ctx, dy):
        cos, sin = ctx.saved_tensors
        fn = rope_plain if ctx.plain else rope_apply
        return fn(dy.contiguous(), cos, -sin), None, None, None
