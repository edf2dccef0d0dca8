"""Rotate-half rotary position embedding of q and k: CUDA kernel, plain
version and the autograd Function.

Replaces ``paddle_tpu/ops/kernels/rope_pallas.py`` ``_rope_call`` (:48;
kernel body :28-36), reached through the custom_vjp ``rope_apply``
(:86-103), which the JAX ``F.rope`` calls once for q and once for k.
Source: ``paddle_tpu_torch/csrc/rope.cu``. :func:`rope_qk` rotates q and k
in one launch; rotation is orthogonal, so the backward is the same launch
rotating by ``-theta`` (``inverse=True``: a sign the kernel applies to sin
in registers, no ``-sin`` table) (:class:`RoPEFunction`); the tables take
no gradient.

What bounds it on the H100: bytes — q and k read once and written once,
the f32 cos/sin rows of a token read from DRAM once. The kernel gives one
thread to each (token, head, 8-element chunk of the first half), so a
decode step's 8 tokens fill tens of blocks, and every thread issues its
loads before its first product.

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

__all__ = ["rope_qk", "rope_apply", "rope_plain", "RoPEFunction"]

_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                      ctypes.c_void_p]


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


def rope_plain(x, cos, sin, inverse=False):
    """The same function in plain PyTorch, f32 inside, cast once;
    ``inverse`` rotates by ``-theta``."""
    _check(x, cos, sin)
    b, s, _, d = x.shape
    shape = (1, s, 1, d) if cos.shape[0] == s else (b, s, 1, d)
    c, sn = cos.reshape(shape), sin.reshape(shape)
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    rot = torch.cat([-x2, x1], dim=-1)
    return (xf * c - rot * sn if inverse else xf * c + rot * sn).to(x.dtype)


def rope_qk(q, k, cos, sin, inverse=False):
    """RoPE on ``q [B, S, H, D]`` and ``k [B, S, Hk, D]`` (or ``None``) with
    the same tables, in one launch; ``inverse`` rotates by ``-theta`` (the
    adjoint). Returns ``(q', k')``. A CPU tensor takes :func:`rope_plain`;
    a CUDA tensor launches the kernel (bf16, contiguous, D % 4 == 0) or
    raises."""
    _check(q, cos, sin)
    if k is not None and (k.dim() != 4 or k.shape[:2] != q.shape[:2]
                          or k.shape[3] != q.shape[3] or k.dtype != q.dtype
                          or k.device != q.device):
        # the tables fit k as they fit q: the same B, S and D
        raise ValueError(f"rope: k {tuple(k.shape)} {k.dtype} does not "
                         f"pair with q {tuple(q.shape)} {q.dtype}")
    if q.device.type == "cpu":
        return (rope_plain(q, cos, sin, inverse),
                None if k is None else rope_plain(k, cos, sin, inverse))
    if q.device.type != "cuda":
        raise ValueError(f"rope: no kernel for device {q.device}")
    d = q.shape[3]
    if q.dtype != torch.bfloat16:
        raise TypeError(f"rope kernel takes bf16, got {q.dtype}")
    if d % 4:
        raise ValueError(f"rope kernel needs D % 4 == 0, got {d}")
    ops = [t for t in (q, k, cos, sin) if t is not None]
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("rope kernel takes contiguous tensors")
    _build.require_aligned("rope", *ops)
    q_out = torch.empty_like(q)
    k_out = None if k is None else torch.empty_like(k)
    _launch(q, k, cos, sin, q_out, k_out, inverse, _build.stream_of(q))
    rope_qk.launches += 1
    return q_out, k_out


rope_qk.launches = 0


def rope_apply(x, cos, sin):
    """RoPE on one tensor ``x [B, S, H, D]``: :func:`rope_qk` without k."""
    return rope_qk(x, None, cos, sin)[0]


def _launch(q, k, cos, sin, q_out, k_out, inverse, stream):
    """The C entry on operands the caller allocated (``k``, ``k_out`` may
    be None)."""
    b, s, hq, d = q.shape
    hk = 0 if k is None else k.shape[2]
    fn = _build.function("rope", "ptt_rope", _ARGS)
    _build.check(fn(q.data_ptr(), None if k is None else k.data_ptr(),
                    cos.data_ptr(), sin.data_ptr(), q_out.data_ptr(),
                    None if k_out is None else k_out.data_ptr(), b * s, hq,
                    hk, d, s, int(cos.shape[0] == b * s),
                    -1.0 if inverse else 1.0, stream), "rope")


class RoPEFunction(torch.autograd.Function):
    """RoPE of q and k with its adjoint, rotation by ``-theta``:
    ``apply(q, k, cos, sin, plain)`` returns ``(q', k')``; ``k`` may be
    None. ``plain`` runs the plain version both ways. Forward and backward
    are one launch each."""

    @staticmethod
    def forward(ctx, q, k, cos, sin, plain):
        ctx.save_for_backward(cos, sin)
        ctx.plain = plain
        ctx.has_k = k is not None
        if plain:
            return (rope_plain(q, cos, sin),
                    None if k is None else rope_plain(k, cos, sin))
        return rope_qk(q, k, cos, sin)

    @staticmethod
    def backward(ctx, dq, dk):
        cos, sin = ctx.saved_tensors
        dq = dq.contiguous()
        dk = dk.contiguous() if ctx.has_k else None
        if ctx.plain:
            gq = rope_plain(dq, cos, sin, inverse=True)
            gk = None if dk is None else rope_plain(dk, cos, sin,
                                                    inverse=True)
        else:
            gq, gk = rope_qk(dq, dk, cos, sin, inverse=True)
        return gq, gk, None, None, None


# -- declared launches for the kernel analyzer -------------------------------

def _ex(label, b, s, h, d, per_token, hk=0):
    """One thread a (token, head, VEC-wide chunk of the first half): the q
    heads of a token, then its k heads (``hk`` of them; none for one
    tensor); block j takes threads [128 j, 128 (j + 1)) of that order. A
    thread's tile is its chunk in both halves of the head (x seen as
    [tokens, heads, 2, D / 2]); where a block holds whole heads (128 a
    multiple of the chunks a head), a tile is a head row."""
    from ._examples import model, uniform
    m = model()
    tokens = b * s
    rows = tokens if per_token else s
    vec = 8 if (d // 2) % 8 == 0 else 2
    chunks = d // 2 // vec
    threads = tokens * (h + hk) * chunks
    grid = -(-threads // 128)
    unit = chunks if 128 % chunks == 0 else 1       # threads a tile
    width = vec * unit
    f32, bf = torch.float32, torch.bfloat16
    ops = [m.Operand("q", (b, s, h, d), bf),
           m.Operand("cos", (rows, d), f32, data=uniform((rows, d), f32, -1, 1)),
           m.Operand("sin", (rows, d), f32, data=uniform((rows, d), f32, -1, 1)),
           m.Operand("q_out", (b, s, h, d), bf, "out")]
    if hk:
        ops[1:1] = [m.Operand("k", (b, s, hk, d), bf)]
        ops.append(m.Operand("k_out", (b, s, hk, d), bf, "out"))

    def span(j):
        """(token, head, first chunk) of each tile of block j."""
        lo = 128 * j // unit
        hi = min(128 * (j + 1), threads) // unit
        return [(i * unit // chunks // (h + hk),
                 i * unit // chunks % (h + hk), i * unit % chunks)
                for i in range(lo, hi)]

    def x_map(name, heads, is_q):
        def index(j, y, z):
            return [(t, hh if is_q else hh - h, 0, c // unit)
                    for t, hh, c in span(j) if (hh < h) == is_q]
        return m.TileMap(name, (1, 1, 2, width), index,
                         view=(tokens, heads, 2, d // 2))

    def table(name):
        return m.TileMap(name, (1, 2, width), lambda j, y, z: sorted({
            (t if per_token else t % s, 0, c // unit) for t, _, c in span(j)}),
            view=(rows, 2, d // 2))

    writes = [x_map("q_out", h, True)]
    reads = [x_map("q", h, True), table("cos"), table("sin")]
    if hk:
        writes.append(x_map("k_out", hk, False))
        reads.append(x_map("k", hk, False))
    kern = m.KernelLaunch(f"rope_kernel<{vec}>", grid, 128, writes=writes,
                          reads=reads)

    def plain(t):
        out = {"q_out": rope_plain(t["q"], t["cos"], t["sin"])}
        if hk:
            out["k_out"] = rope_plain(t["k"], t["cos"], t["sin"])
        return out

    def launch(t, stream):
        _launch(t["q"], t.get("k"), t["cos"], t["sin"], t["q_out"],
                t.get("k_out"), False, stream)

    n = tokens * (h + hk) * d
    return m.Example(label, "rope", ops, [kern], launch, plain, flops=3 * n,
                     nbytes=2 * n * 2 + 2 * rows * d * 4)


def ck_examples():
    """At ``rope_pallas.pk_examples``' shape (x [2, 1024, 16, 128], tables
    [1024, 128] shared by the batch; one tensor) and phase 3's: the decode
    pair q [8, 1, 32, 128] + k [8, 1, 8, 128] with per-token tables, the
    prefill pair q [1, 512, 32, 128] + k [1, 512, 8, 128], and the
    three one-tensor rows of earlier runs (q [8, 1, 32, 128] per-token, q
    [1, 512, 32, 128] and k [1, 512, 8, 128]); tails of 37 positions a
    row and a head width of 68 (the 4-byte path: its half, 34, is no
    multiple of 8, and a head's 17 threads straddle blocks)."""
    from ._examples import with_tail
    out = []
    for label, b, s, h, hk, d, per in (
            ("rope", 2, 1024, 16, 0, 128, False),
            ("phase3 [8, 1, 32, 128]", 8, 1, 32, 0, 128, True),
            ("phase3 [1, 512, 32, 128]", 1, 512, 32, 0, 128, True),
            ("phase3 [1, 512, 8, 128]", 1, 512, 8, 0, 128, True),
            ("phase3 q [8, 1, 32, 128] + k [8, 1, 8, 128]", 8, 1, 32, 8, 128,
             True),
            ("phase3 q [1, 512, 32, 128] + k [1, 512, 8, 128]", 1, 512, 32, 8,
             128, True)):
        out.append(with_tail(_ex, label, dict(b=b, s=s, h=h, hk=hk, d=d,
                                              per_token=per),
                             dict(b=b, s=37, h=3, hk=1 if hk else 0, d=68,
                                  per_token=per)))
    return out
