"""SwiGLU gate ``silu(g) * u``, forward and backward, on two operands or
on one packed ``[.., 2I]`` operand: CUDA kernels, plain versions and the
autograd Functions.

Replaces ``paddle_tpu/ops/kernels/swiglu_pallas.py`` ``_fused_fwd`` (:81;
kernel body :45-48) and ``_fused_bwd`` (:117; kernel body :58-66), reached
through the custom_vjp ``swiglu_fused`` (:162-179), and the packed pair
``_fused_fwd_packed`` (:99; kernel body :51-55) and ``_fused_bwd_packed``
(:136; kernel body :68-77), reached through ``swiglu_packed``
(:182-209). Source: ``paddle_tpu_torch/csrc/swiglu.cu``.

What bounds all four on the H100: bytes — the forward reads two halves
and writes one, the backward reads three (``g``, ``u``, ``dy``) and writes
two (``dg``, ``du``), a few operations per element. Each kernel is a
grid-stride loop over 16-byte vectors (8 elements a thread per step), f32
inside; the backward recomputes the sigmoid from ``g``. The packed kernels
read the gate and up halves of each ``[2I]`` row in place and write the
backward's ``[dg | du]`` packed the same way, so no split or concatenated
copy is made; they need ``I % 8 == 0`` (every vector inside one half).
The JAX dispatch sends a packed row to its kernel only when ``2I % 256 ==
0`` (``paddle_tpu/ops/activation.py:168-172``); the port's wrapper
launches for every ``I % 8 == 0`` on the card and raises otherwise.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["swiglu", "swiglu_plain", "swiglu_bwd", "swiglu_bwd_plain",
           "SwiGLUFunction", "swiglu_packed", "swiglu_packed_plain",
           "swiglu_packed_bwd", "swiglu_packed_bwd_plain",
           "SwiGLUPackedFunction"]

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_void_p]
_PACKED_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int,
                                        ctypes.c_void_p]
_PACKED_BWD_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_void_p]


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
    _launch(g, u, y, _build.stream_of(g))
    swiglu.launches += 1
    return y


swiglu.launches = 0


def _launch(g, u, y, stream):
    """The forward's C entry on operands the caller allocated."""
    fn = _build.function("swiglu", "ptt_swiglu", _ARGS)
    _build.check(fn(g.data_ptr(), u.data_ptr(), y.data_ptr(), g.numel(),
                    stream), "swiglu")


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
    _launch_bwd(g, u, dy, dg, du, _build.stream_of(g))
    swiglu_bwd.launches += 1
    return dg, du


swiglu_bwd.launches = 0


def _launch_bwd(g, u, dy, dg, du, stream):
    """The backward's C entry on operands the caller allocated."""
    fn = _build.function("swiglu", "ptt_swiglu_bwd", _BWD_ARGS)
    _build.check(fn(g.data_ptr(), u.data_ptr(), dy.data_ptr(), dg.data_ptr(),
                    du.data_ptr(), g.numel(), stream), "swiglu backward")


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


# -- packed: one [.., 2I] operand, gate half first ------------------------------

def _check_packed(x, dy=None):
    if not x.is_floating_point():
        raise TypeError(f"packed swiglu takes a floating tensor, got "
                        f"{x.dtype}")
    if x.dim() < 1 or x.shape[-1] % 2:
        raise ValueError(f"packed swiglu takes x [..., 2I], got "
                         f"{tuple(x.shape)}")
    if dy is not None and (dy.shape != x.shape[:-1] + (x.shape[-1] // 2,)
                           or dy.dtype != x.dtype or dy.device != x.device):
        raise ValueError(f"packed swiglu backward: dy {dy.dtype} "
                         f"{tuple(dy.shape)} does not fit x {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def _packed_launch_check(what, *tensors):
    x = tensors[0]
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{what} kernel takes bf16, got {x.dtype}")
    if (x.shape[-1] // 2) % 8:
        raise ValueError(f"{what} kernel needs I % 8 == 0, got x "
                         f"{tuple(x.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} kernel takes contiguous tensors")
    _build.require_aligned(what, *tensors)


def swiglu_packed_plain(x):
    """``silu(x[..., :I]) * x[..., I:]`` in plain PyTorch, f32 inside."""
    _check_packed(x)
    i = x.shape[-1] // 2
    xf = x.float()
    g = xf[..., :i]
    return (g * torch.sigmoid(g) * xf[..., i:]).to(x.dtype)


def swiglu_packed(x):
    """``[.., I]`` gate of a packed ``[.., 2I]`` row. A CPU tensor takes
    :func:`swiglu_packed_plain`; a CUDA tensor launches the kernel (bf16,
    contiguous, I % 8 == 0) or raises."""
    _check_packed(x)
    if x.device.type == "cpu":
        return swiglu_packed_plain(x)
    _packed_launch_check("packed swiglu", x)
    i = x.shape[-1] // 2
    y = torch.empty(x.shape[:-1] + (i,), dtype=x.dtype, device=x.device)
    _launch_packed(x, y, _build.stream_of(x))
    swiglu_packed.launches += 1
    return y


swiglu_packed.launches = 0


def _launch_packed(x, y, stream):
    """The packed forward's C entry on operands the caller allocated."""
    i = x.shape[-1] // 2
    fn = _build.function("swiglu", "ptt_swiglu_packed", _PACKED_ARGS)
    _build.check(fn(x.data_ptr(), y.data_ptr(),
                    x.numel() // (2 * i) if i else 0, i, stream),
                 "packed swiglu")


def swiglu_packed_bwd_plain(x, dy):
    """``dx = [dg | du]`` of the packed gate for the cotangent ``dy``,
    f32 inside, as :func:`swiglu_bwd_plain` computes each half."""
    _check_packed(x, dy)
    i = x.shape[-1] // 2
    xf = x.float()
    g, u = xf[..., :i], xf[..., i:]
    sig = torch.sigmoid(g)
    s = g * sig
    dyf = dy.float()
    return torch.cat([dyf * u * sig * (1.0 + g - s), dyf * s],
                     dim=-1).to(x.dtype)


def swiglu_packed_bwd(x, dy):
    """``dx [.., 2I]``, as :func:`swiglu_packed_bwd_plain`. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (bf16,
    contiguous, I % 8 == 0) or raises."""
    _check_packed(x, dy)
    if x.device.type == "cpu":
        return swiglu_packed_bwd_plain(x, dy)
    _packed_launch_check("packed swiglu backward", x, dy)
    i = x.shape[-1] // 2
    dx = torch.empty_like(x)
    _launch_packed_bwd(x, dy, dx, _build.stream_of(x))
    swiglu_packed_bwd.launches += 1
    return dx


swiglu_packed_bwd.launches = 0


def _launch_packed_bwd(x, dy, dx, stream):
    """The packed backward's C entry on operands the caller allocated."""
    i = x.shape[-1] // 2
    fn = _build.function("swiglu", "ptt_swiglu_packed_bwd", _PACKED_BWD_ARGS)
    _build.check(fn(x.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                    x.numel() // (2 * i) if i else 0, i, stream),
                 "packed swiglu backward")


class SwiGLUPackedFunction(torch.autograd.Function):
    """The packed gate with its backward kernel (the custom_vjp of
    ``swiglu_packed``, which saves ``x``). ``apply(x, plain)``; ``plain``
    runs the plain forward and the plain backward."""

    @staticmethod
    def forward(ctx, x, plain):
        ctx.save_for_backward(x)
        ctx.plain = plain
        return (swiglu_packed_plain if plain else swiglu_packed)(x)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        bwd = swiglu_packed_bwd_plain if ctx.plain else swiglu_packed_bwd
        return bwd(x, dy.contiguous()), None


# -- declared launches for the kernel analyzer -------------------------------

_THREADS, _MAX_BLOCKS = 256, 132 * 16


def _blocks(n8: int) -> int:
    return max(1, min(_MAX_BLOCKS, -(-n8 // _THREADS)))


def _packed_bwd_map(rows, width, grid):
    """dx [rows, 2I] seen as [rows, 2, I]: vector v (row v // (I / 8),
    column 8 (v % (I / 8))) writes its 8 columns in both halves, and block
    b takes vectors [256 j, 256 (j + 1)) for j = b, b + grid, ... When a
    row holds whole chunks, a chunk is one (1, 2, 2048) tile."""
    from ._examples import model
    m = model()
    iv = width // 8
    n_vec = rows * iv
    n_chunks = -(-n_vec // _THREADS)
    if iv % _THREADS == 0:
        per_row = iv // _THREADS
        return m.TileMap("dx", (1, 2, _THREADS * 8), lambda bx, by, bz: [
            (j // per_row, 0, j % per_row)
            for j in range(bx, n_chunks, grid)], view=(rows, 2, width))

    def index(bx, by, bz):
        out = []
        for j in range(bx, n_chunks, grid):
            for v in range(j * _THREADS, min((j + 1) * _THREADS, n_vec)):
                out += [(v // iv, 0, v % iv), (v // iv, 1, v % iv)]
        return out
    return m.TileMap("dx", (1, 1, 8), index, view=(rows, 2, width))


def _ex(label, rows, width, kind):
    """``kind``: "fwd" / "bwd" on [rows, width] operands, or "packed" /
    "packed_bwd" on x [rows, 2 width]. A grid-stride loop over 8-element
    vectors: block b covers chunks b, b + grid, ... of 2048 elements."""
    from ._examples import model
    m = model()
    bf = torch.bfloat16
    n = rows * width
    grid = _blocks(n // 8)
    chunk = _THREADS * 8
    flat = (rows, width)
    if kind in ("fwd", "bwd"):
        ins = ["g", "u"] + (["dy"] if kind == "bwd" else [])
        outs = ["y"] if kind == "fwd" else ["dg", "du"]
        ops = [m.Operand(k, flat, bf) for k in ins] + \
            [m.Operand(k, flat, bf, "out") for k in outs]
        writes = [m.stride_map(k, n, chunk, grid) for k in outs]
        reads = [m.stride_map(k, n, chunk, grid) for k in ins]
        if kind == "fwd":
            def plain(t):
                return {"y": swiglu_plain(t["g"], t["u"])}

            def launch(t, stream):
                _launch(t["g"], t["u"], t["y"], stream)
        else:
            def plain(t):
                dg, du = swiglu_bwd_plain(t["g"], t["u"], t["dy"])
                return {"dg": dg, "du": du}

            def launch(t, stream):
                _launch_bwd(t["g"], t["u"], t["dy"], t["dg"], t["du"], stream)
    else:
        packed = (rows, 2 * width)
        grid = _blocks(rows * (width // 8))
        if kind == "packed":
            ops = [m.Operand("x", packed, bf), m.Operand("y", flat, bf, "out")]
            writes = [m.stride_map("y", n, chunk, grid)]

            def plain(t):
                return {"y": swiglu_packed_plain(t["x"])}

            def launch(t, stream):
                _launch_packed(t["x"], t["y"], stream)
        else:
            ops = [m.Operand("x", packed, bf), m.Operand("dy", flat, bf),
                   m.Operand("dx", packed, bf, "out")]
            writes = [_packed_bwd_map(rows, width, grid)]

            def plain(t):
                return {"dx": swiglu_packed_bwd_plain(t["x"], t["dy"])}

            def launch(t, stream):
                _launch_packed_bwd(t["x"], t["dy"], t["dx"], stream)
        reads = []
    name = {"fwd": "swiglu_kernel", "bwd": "swiglu_bwd_kernel",
            "packed": "swiglu_packed_kernel",
            "packed_bwd": "swiglu_packed_bwd_kernel"}[kind]
    fwd = kind in ("fwd", "packed")
    return m.Example(label, "swiglu", ops,
                     [m.KernelLaunch(name, grid, _THREADS, writes=writes,
                                     reads=reads)], launch, plain,
                     flops=(6 if fwd else 12) * n,
                     nbytes=(3 if fwd else 5) * n * 2)


def ck_examples():
    """At ``swiglu_pallas.pk_examples``' shapes ([512, 2048]; packed
    [512, 2 x 2048]) and phase 3's ([8, 14336] and [512, 14336] forward,
    [4096, 14336] backward, packed [4096, 2 x 14336] both ways); tails with
    a partial last chunk (and, unpacked, an element count that is not a
    multiple of 8)."""
    from ._examples import with_tail
    out = []
    for label, rows, width, kind in (
            ("swiglu_fwd", 512, 2048, "fwd"),
            ("swiglu_bwd", 512, 2048, "bwd"),
            ("swiglu_fwd_packed", 512, 2048, "packed"),
            ("swiglu_bwd_packed", 512, 2048, "packed_bwd"),
            ("phase3 [8, 14336]", 8, 14336, "fwd"),
            ("phase3 [512, 14336]", 512, 14336, "fwd"),
            ("phase3 bwd [4096, 14336]", 4096, 14336, "bwd"),
            ("phase3 packed [4096, 2 x 14336]", 4096, 14336, "packed"),
            ("phase3 packed bwd [4096, 2 x 14336]", 4096, 14336,
             "packed_bwd")):
        packed = kind.startswith("packed")
        tail = dict(rows=37, width=width + (8 if packed else 5), kind=kind)
        out.append(with_tail(_ex, label, dict(rows=rows, width=width,
                                              kind=kind), tail))
    return out
