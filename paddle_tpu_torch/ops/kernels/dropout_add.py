"""Counter-hash dropout + residual add: the CUDA kernel (forward and
backward), the plain versions, the autograd Function, and the hash itself.

Replaces ``paddle_tpu/ops/kernels/dropout_add_pallas.py`` ``_fwd`` (:98;
kernel body ``_fwd_kernel`` :77) and ``_bwd`` (:118; kernel body
``_bwd_kernel`` :86), with the custom_vjp ``dropout_add`` (:141-169).
Source: ``paddle_tpu_torch/csrc/dropout_add.cu``.

    keep = fmix32(idx ^ seed * 0x9E3779B9) >= threshold
    y    = (keep ? x * scale : 0) + residual          in f32, one rounding
    dx   = keep ? dy * scale : 0,   dresidual = dy

``idx`` is the element's uint32 flat index (it wraps at 2**32, as JAX's
does) and ``(threshold, scale) = dropout_params(p)`` (``_params``,
:135-138). The mask is a function of the seed and the index alone, so the
kernel, the plain version and the TPU kernel drop the same elements bit
for bit, and the backward regenerates the forward's mask from the seed:
the Function saves the seed, never a mask. The block epilogue
(``block_epilogue.py``, rows 9-10) draws its dropout from the same hash,
imported from here as JAX's ``block_fused_pallas.py:60`` imports it.

What bounds it on the H100: bytes. The kernel walks the flat tensor in
8-element chunks with 16-byte accesses. Unlike JAX, which sends arrays
under 1024 elements to its composite (``use_kernel``, :172-175), the
wrapper launches the kernel for every size on the card. bf16 or f32; a
CPU tensor takes the plain version, a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

__all__ = ["dropout_add", "dropout_add_plain", "dropout_add_bwd",
           "dropout_add_bwd_plain", "DropoutAddFunction", "dropout_params",
           "keep_mask"]

_GOLDEN = 0x9E3779B9
_MASK32 = 0xFFFFFFFF
_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_uint, ctypes.c_uint, ctypes.c_float,
                                 ctypes.c_void_p]
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def dropout_params(p: float):
    """``(threshold, scale)`` for drop probability ``p``
    (``dropout_add_pallas._params``)."""
    threshold = min(int(p * 4294967296.0), 4294967295)
    return threshold, 1.0 / (1.0 - p)


def _mul32(a, c: int):
    """``a * c mod 2**32`` for an int64 tensor ``a`` in ``[0, 2**32)``,
    split so that no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK32


def _fmix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def keep_mask(n_rows: int, hidden: int, seed: int, p: float, device="cpu"):
    """Bool ``[n_rows, hidden]``: the elements the counter-hash dropout
    keeps (uint32 arithmetic carried in int64)."""
    threshold, _ = dropout_params(p)
    idx = torch.arange(n_rows * hidden, dtype=torch.int64,
                       device=device) & _MASK32
    key = ((int(seed) & _MASK32) * _GOLDEN) & _MASK32
    bits = _fmix32(idx ^ key)
    return (bits >= threshold).reshape(n_rows, hidden)


def _check(x, other, what):
    if not x.is_floating_point():
        raise TypeError(f"{what} takes floating tensors, got {x.dtype}")
    if other is not None and (other.shape != x.shape
                              or other.dtype != x.dtype
                              or other.device != x.device):
        raise ValueError(f"{what}: operands {x.dtype} {tuple(x.shape)} on "
                         f"{x.device} and {other.dtype} "
                         f"{tuple(other.shape)} on {other.device} differ")


def _keep(x, seed, p):
    return keep_mask(1, x.numel(), seed, p, x.device).reshape(x.shape)


def dropout_add_plain(x, residual, seed: int, p: float):
    """The forward in plain PyTorch, as ``reference_dropout_add``
    (:178-191): f32 inside, one rounding to ``x.dtype``."""
    _check(x, residual, "dropout_add")
    _, scale = dropout_params(p)
    kept = torch.where(_keep(x, seed, p), x.float() * np.float32(scale), 0.0)
    return (kept + residual.float()).to(x.dtype)


def dropout_add_bwd_plain(dy, seed: int, p: float):
    """``dx = keep ? dy * scale : 0`` in plain PyTorch (``_bwd_kernel``)."""
    _check(dy, None, "dropout_add backward")
    _, scale = dropout_params(p)
    return torch.where(_keep(dy, seed, p), dy.float() * np.float32(scale),
                       0.0).to(dy.dtype)


def _run(x, residual, seed, p, what):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{what} kernel takes bf16 or f32, got {x.dtype}")
    ops = [t for t in (x, residual) if t is not None]
    if not all(t.is_contiguous() for t in ops):
        raise ValueError(f"{what} kernel takes contiguous tensors")
    _build.require_aligned(what, *ops)
    out = torch.empty_like(x)
    _launch(x, residual, out, seed, p, what, _build.stream_of(x))
    return out


def _launch(x, residual, out, seed, p, what, stream):
    """The C entry on operands the caller allocated (``residual`` None:
    the backward)."""
    threshold, scale = dropout_params(p)
    fn = _build.function("dropout_add", "ptt_dropout_add", _ARGS)
    err = fn(x.data_ptr(), None if residual is None else residual.data_ptr(),
             out.data_ptr(), x.numel(), int(x.dtype == torch.float32),
             int(seed) & _MASK32, threshold, float(scale), stream)
    _build.check(err, what)


def dropout_add(x, residual, seed: int, p: float):
    """``y = dropout(x) + residual`` with the counter-hash mask of ``seed``
    (an int32) at drop probability ``0 < p < 1``, in ``x.dtype``. A CPU
    tensor takes :func:`dropout_add_plain`; a CUDA tensor launches the
    kernel (bf16 or f32, contiguous) or raises."""
    _check(x, residual, "dropout_add")
    if x.device.type == "cpu":
        return dropout_add_plain(x, residual, seed, p)
    y = _run(x, residual, seed, p, "dropout_add")
    dropout_add.launches += 1
    return y


dropout_add.launches = 0


def dropout_add_bwd(dy, seed: int, p: float):
    """``dx``, as :func:`dropout_add_bwd_plain`; the same dispatch as
    :func:`dropout_add`. ``dresidual`` is ``dy`` itself."""
    _check(dy, None, "dropout_add backward")
    if dy.device.type == "cpu":
        return dropout_add_bwd_plain(dy, seed, p)
    dx = _run(dy, None, seed, p, "dropout_add backward")
    dropout_add_bwd.launches += 1
    return dx


dropout_add_bwd.launches = 0


class DropoutAddFunction(torch.autograd.Function):
    """``dropout_add`` with its backward kernel (the custom_vjp,
    :141-169). ``apply(x, residual, seed, p, plain)``; it saves the seed
    alone, as the TPU kernel does. ``plain`` runs the plain forward and
    backward."""

    @staticmethod
    def forward(ctx, x, residual, seed, p, plain):
        ctx.args = (int(seed), float(p))
        ctx.plain = plain
        return (dropout_add_plain if plain else dropout_add)(
            x, residual, seed, p)

    @staticmethod
    def backward(ctx, dy):
        dy = dy.contiguous()
        bwd = dropout_add_bwd_plain if ctx.plain else dropout_add_bwd
        dx = bwd(dy, *ctx.args) if ctx.needs_input_grad[0] else None
        return dx, dy, None, None, None


# -- declared launches for the kernel analyzer -------------------------------

_THREADS = 256


def _ex(label, rows, hd, bwd, dtype=torch.bfloat16):
    """A grid-stride loop of 8 elements a thread over at most 8 blocks an
    SM: block b covers chunks b, b + grid, ... of 2048 elements (block 0
    also the fewer than 8 past the last whole vector)."""
    from ._examples import CTYPE, model
    m = model()
    n = rows * hd
    grid = max(1, min(132 * 8, -(-(n // 8) // _THREADS)))
    ops = [m.Operand("x", (rows, hd), dtype),
           m.Operand("y", (rows, hd), dtype, "out")]
    if not bwd:
        ops.append(m.Operand("res", (rows, hd), dtype))

    def plain(t):
        if bwd:
            return {"y": dropout_add_bwd_plain(t["x"], 1234, 0.1)}
        return {"y": dropout_add_plain(t["x"], t["res"], 1234, 0.1)}

    def launch(t, stream):
        _launch(t["x"], t.get("res"), t["y"], 1234, 0.1, label, stream)

    kern = m.KernelLaunch(
        f"dropout_add_kernel<{CTYPE[dtype]},{str(not bwd).lower()}>", grid,
        _THREADS, writes=[m.stride_map("y", n, 8 * _THREADS, grid)])
    return m.Example(label, "dropout_add", ops, [kern], launch, plain,
                     flops=(13 if bwd else 14) * n,
                     nbytes=(2 if bwd else 3) * n * dtype.itemsize, tol=0.0)


def ck_examples():
    """At ``dropout_add_pallas.pk_examples``' shape ([512, 1024], forward
    and backward) and phase 3's ([8192, 768] and [4096, 4096] at p = 0.1,
    both ways): bit for bit the plain version; tails whose element count
    is not a multiple of 8."""
    from ._examples import with_tail
    out = []
    for label, rows, hd, bwd in (
            ("dropout_add_fwd", 512, 1024, False),
            ("dropout_add_bwd", 512, 1024, True),
            ("phase3 [8192, 768]", 8192, 768, False),
            ("phase3 bwd [8192, 768]", 8192, 768, True),
            ("phase3 [4096, 4096]", 4096, 4096, False),
            ("phase3 bwd [4096, 4096]", 4096, 4096, True)):
        out.append(with_tail(_ex, label, dict(rows=rows, hd=hd, bwd=bwd),
                             dict(rows=37, hd=1001, bwd=bwd)))
    return out
