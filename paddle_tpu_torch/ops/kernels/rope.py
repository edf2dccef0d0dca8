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
    _launch(x, cos, sin, out, _build.stream_of(x))
    rope_apply.launches += 1
    return out


rope_apply.launches = 0


def _launch(x, cos, sin, out, stream):
    """The C entry on operands the caller allocated."""
    b, s, h, d = x.shape
    fn = _build.function("rope", "ptt_rope", _ARGS)
    _build.check(fn(x.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                    out.data_ptr(), b * s, h, d, s,
                    int(cos.shape[0] == b * s), stream), "rope")


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


# -- declared launches for the kernel analyzer -------------------------------

def _ex(label, b, s, h, d, per_token):
    """One block a token: it rotates the token's [H, D] row by table row
    t (per-token tables) or t % S (one row a position)."""
    from ._examples import model, uniform
    m = model()
    tokens = b * s
    rows = tokens if per_token else s
    threads = h * d // 4
    threads = 32 if threads < 32 else (256 if threads > 256
                                       else -(-threads // 32) * 32)
    f32 = torch.float32
    ops = [m.Operand("x", (b, s, h, d), torch.bfloat16),
           m.Operand("cos", (rows, d), f32, data=uniform((rows, d), f32, -1, 1)),
           m.Operand("sin", (rows, d), f32, data=uniform((rows, d), f32, -1, 1)),
           m.Operand("out", (b, s, h, d), torch.bfloat16, "out")]
    table = m.TileMap("cos", (1, d), lambda t, y, z: (t if per_token
                                                      else t % s, 0))
    table_s = m.TileMap("sin", (1, d), table.index)
    kern = m.KernelLaunch(
        "rope_kernel", tokens, threads,
        writes=[m.rows_map("out", tokens, h * d)],
        reads=[m.rows_map("x", tokens, h * d), table, table_s])

    def plain(t):
        return {"out": rope_plain(t["x"], t["cos"], t["sin"])}

    def launch(t, stream):
        _launch(t["x"], t["cos"], t["sin"], t["out"], stream)

    n = tokens * h * d
    return m.Example(label, "rope", ops, [kern], launch, plain, flops=3 * n,
                     nbytes=2 * n * 2 + 2 * rows * d * 4)


def ck_examples():
    """At ``rope_pallas.pk_examples``' shape (x [2, 1024, 16, 128], tables
    [1024, 128] shared by the batch) and phase 3's (decode q [8, 1, 32, 128]
    with per-token tables; prefill q [1, 512, 32, 128] and k [1, 512, 8,
    128]); tails of an odd token count and a head width whose threads do
    not fill the last warp."""
    from ._examples import with_tail
    out = []
    for label, b, s, h, d, per in (
            ("rope", 2, 1024, 16, 128, False),
            ("phase3 [8, 1, 32, 128]", 8, 1, 32, 128, True),
            ("phase3 [1, 512, 32, 128]", 1, 512, 32, 128, True),
            ("phase3 [1, 512, 8, 128]", 1, 512, 8, 128, True)):
        out.append(with_tail(_ex, label, dict(b=b, s=s, h=h, d=d,
                                              per_token=per),
                             dict(b=b, s=s + 37, h=3, d=68, per_token=per)))
    return out
