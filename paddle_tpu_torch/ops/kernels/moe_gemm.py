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
is a TMA and wgmma kernel (``csrc/hopper.cuh``): a block is one (expert,
128-column tile, group of 128 capacity rows), a producer warp streams x's
live 64-row tiles and the weight through a 3-stage ring, and two consumer
warpgroups multiply every live row of the group against each weight box,
so at Qwen's counts an expert's weight crosses from device memory once.
It reads ``counts`` on the device, so nothing synchronises the host: its
grid covers the full capacity and a group wholly past its expert's count
writes its zeros without loading anything. It takes ``w`` either as
``[E, H, F]`` (MN-major, the wgmma's transpose bit) or as the transpose of
an ``[E, F, H]`` tensor (a ``w.transpose(1, 2)`` view, K-major), so the
backward's ``dx = g @ w[e]^T`` reads the forward's weight as it lies:
JAX's ``jnp.swapaxes`` is free to XLA, a contiguous copy here would be
346 MB a stack. Any ``C``, ``H % 8 == 0`` and ``F % 8 == 0`` (the tensor
maps' 16-byte row strides); the JAX kernel pads ``C`` to a multiple of 8
and slices (:80, :96).

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
    _launch(x, w, counts, out, w_nk, _build.stream_of(x))
    grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0


def _launch(x, w, counts, out, w_nk, stream):
    """The C entry on operands the caller allocated; ``w`` is the stored
    ``[E, H, F]`` (``w_nk`` 0) or ``[E, F, H]`` (``w_nk`` 1) tensor."""
    e, c, h = x.shape
    fn = _build.function("moe_gemm", "ptt_moe_gemm", _ARGS)
    err = fn(x.data_ptr(), w.data_ptr(), counts.data_ptr(), out.data_ptr(),
             e, c, h, out.shape[2], int(w_nk), stream)
    _build.check(err, "grouped_matmul")


def skewed_counts(e, n_slots, capacity, seed):
    """Kept slots per expert from a seeded skewed draw, on the CPU:
    ``n_slots`` routed slots spread over ``e`` experts with weights
    ``exp(1.5 z)``, ``z`` standard normal, each expert capped at
    ``capacity``; expert 0 gets none and expert 1 a full queue. int32."""
    gen = torch.Generator().manual_seed(seed)
    p = torch.exp(1.5 * torch.randn(e, generator=gen))
    draw = torch.multinomial(p / p.sum(), n_slots, replacement=True,
                             generator=gen)
    counts = torch.bincount(draw, minlength=e).clamp(max=capacity)
    counts[0], counts[1] = 0, capacity
    return counts.to(torch.int32)


# -- declared launches for the kernel analyzer -------------------------------

#: the source's kBM, kBN, kBK, kStages and kThreads: rows of a group,
#: columns of a tile, k of a ring stage, ring stages, threads a block
_BM, _BN, _BK, _STAGES, _THREADS = 128, 128, 64, 3, 288
#: dynamic shared memory: a 1 KB alignment pad, the ring (two 64-row x
#: boxes and the weight's 128 x 64 box a stage) and its mbarriers
_SMEM = 1024 + _STAGES * (2 * 64 * _BK * 2 + _BN * _BK * 2) + 2 * _STAGES * 8


def plan(c, n, e):
    """The launch: grid ``(N / 128, C / 128, E)`` (a block a column tile of
    a row group of an expert, the column tiles fastest), threads, shared
    memory."""
    return (-(-n // _BN), -(-c // _BM), e), _THREADS, _SMEM


def _ex(label, e, c, k, n, counts, w_nk=False):
    """A block a [128, 128] tile of one expert's output: a group past the
    count is written with zeros and loads nothing, rows past the count in
    a live group are written as zeros. ``w_nk``: the weight stored [E, N,
    K] (the backward's transposed view of a forward stack)."""
    from ._examples import fixed, model, normal
    m = model()
    bf = torch.bfloat16
    w_shape = (e, n, k) if w_nk else (e, k, n)
    ops = [m.Operand("x", (e, c, k), bf),
           m.Operand("w", w_shape, bf, data=normal(w_shape, bf, 0.02)),
           m.Operand("counts", (e,), torch.int32, data=fixed(counts)),
           m.Operand("out", (e, c, n), bf, "out")]

    def plain(t):
        w = t["w"].transpose(1, 2) if w_nk else t["w"]
        return {"out": grouped_matmul_plain(t["x"], w, t["counts"])}

    def launch(t, stream):
        _launch(t["x"], t["w"], t["counts"], t["out"], w_nk, stream)

    grid, threads, smem = plan(c, n, e)
    kern = m.KernelLaunch(
        f"moe_wgmma_kernel<{str(w_nk).lower()}>", grid, threads, smem=smem,
        writes=[m.TileMap("out", (1, _BM, _BN), lambda x, y, z: (z, y, x))])
    rows = int(counts.clamp(0, c).sum())
    experts = int((counts > 0).sum())
    return m.Example(label, "moe_gemm", ops, [kern], launch, plain,
                     flops=2 * rows * k * n,
                     nbytes=(experts * k * n + rows * k + e * c * n) * 2
                     + 4 * e, unit="bf16")


def ck_examples():
    """At ``moe_gemm_pallas.pk_examples``' shape (x [8, 256, 1024] @ [8,
    1024, 4096]) and phase 3's (one Qwen1.5-MoE layer at 2048 tokens: 60
    experts of capacity 274, gate/up [60, 274, 2048] @ [60, 2048, 1408],
    down [60, 274, 1408] @ [60, 1408, 2048], and dx through the transposed
    view of the gate/up stack; and train_moe's capacity 547 at 4096 tokens
    for gate/up and dx), counts from ``skewed_counts`` with an empty and a
    full expert; tails with C, K and N past their last full tile."""
    from ._examples import with_tail
    cap, cap_train = 274, 547
    counts = skewed_counts(60, 2048 * 4, cap, seed=81)
    counts_train = skewed_counts(60, 4096 * 4, cap_train, seed=81)
    tail = dict(e=3, c=37, k=72, n=136,
                counts=torch.tensor([0, 37, 20], dtype=torch.int32))
    return [with_tail(_ex, label, dict(e=e, c=c, k=k, n=n, counts=cn,
                                       w_nk=nk), dict(tail, w_nk=nk))
            for label, e, c, k, n, cn, nk in (
                ("grouped_gemm", 8, 256, 1024, 4096,
                 skewed_counts(8, 1024, 256, seed=0), False),
                ("phase3 gate/up [60, 274, 2048] @ [60, 2048, 1408]", 60, cap,
                 2048, 1408, counts, False),
                ("phase3 down [60, 274, 1408] @ [60, 1408, 2048]", 60, cap,
                 1408, 2048, counts, False),
                ("phase3 dx [60, 274, 1408] @ [60, 2048, 1408]^T", 60, cap,
                 1408, 2048, counts, True),
                ("phase3 gate/up [60, 547, 2048] @ [60, 2048, 1408]", 60,
                 cap_train, 2048, 1408, counts_train, False),
                ("phase3 dx [60, 547, 1408] @ [60, 2048, 1408]^T", 60,
                 cap_train, 1408, 2048, counts_train, True))]


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
