"""Weight-only int8 / int4 matrix products ``x @ dequant(w)``: CUDA kernels
and plain versions (counterpart of ``paddle_tpu/ops/kernels/wo_matmul_pallas.py``).

Replaces three TPU kernel bodies. Source:
``paddle_tpu_torch/csrc/wo_matmul.cu``.

- ``_wo_kernel`` (:33), reached through ``wo_int8_matmul`` (:70) with
  per-channel scales ``[N]``: ``(x @ w) * s`` with f32 accumulation, the
  f32 scale applied to the f32 sum, one cast to ``x.dtype``. Wrapper
  :func:`wo_int8`.
- ``_wo_g_kernel`` (:41), through ``wo_int8_matmul`` with grouped scales
  ``[K/G, N]``: the weight dequantized first, ``f32(w) * s[k // G, n]``
  rounded to ``x.dtype`` BEFORE the contraction (:49-50), then ``x @ wd``
  with f32 accumulation and one cast. Wrapper :func:`wo_int8_grouped`.
- ``_wo4_kernel`` (:176), through ``wo_int4_matmul`` (:213): packed
  ``[K, N/2]`` bytes in the halves layout (byte ``j`` holds column ``j`` in
  its low nibble and column ``j + N/2`` in its high nibble, both
  sign-extended), per-channel scales ``[N]``. Wrapper :func:`wo_int4`.

:func:`wo_int8_matmul` and :func:`wo_int4_matmul` take any leading shape
and the JAX package's checks and messages. The plain versions compute
what the TPU kernels compute, which is not what the JAX package's
``reference_wo_int8_matmul`` / ``reference_wo_int4_matmul`` composites
compute: those round ``x @ w`` to ``x.dtype`` and then multiply by a scale
cast to ``x.dtype`` (two roundings). In f32 the two agree within f32
summation order.

What bounds the kernels on the H100: bytes in decode (M = 1..8 rows: the
weight is read once, 58.7 MB for Llama-3-8B's gate_proj at int8, 0.018 ms
at 3.35 TB/s), operations in prefill (M = 64..2048: 120 GFLOP for
gate_proj at M 1024, 0.12 ms at the 989 TFLOP/s bf16 tensor-core rate).
The design is one ``mma.sync`` bf16 kernel with two tilings (the CUDA
source describes both): the int8 or nibble tile converts to bf16 exactly
in shared memory, the scales apply in the f32 epilogue.

The card path takes bf16 activations only; f32 activations (the CPU
tests' dtype, which the TPU kernel also takes) raise on the card
(:func:`unsupported_reason`). A CPU tensor takes the plain version; a
CUDA tensor launches the kernel or raises. Nothing falls back to a
composite (the JAX package's ``_wo_dispatch`` does, with a warning).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["wo_int8_matmul", "wo_int4_matmul", "wo_int8", "wo_int8_grouped",
           "wo_int4", "wo_int8_matmul_plain", "wo_int4_matmul_plain",
           "dequant_grouped", "pack_int4_halves", "unpack_int4_halves",
           "unsupported_reason"]

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_ARGS_G = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


# -- layouts (the port's own copies of the JAX package's) -----------------------

def dequant_grouped(w_q, scales):
    """``[K, N]`` int8 x ``[K/G, N]`` scales -> f32 ``[K, N]`` (the JAX
    package's one grouped dequant, ``wo_matmul_pallas.py:130-136``)."""
    k, n = w_q.shape
    g = k // scales.shape[0]
    return (w_q.reshape(k // g, g, n).float()
            * scales[:, None, :].float()).reshape(k, n)


def pack_int4_halves(q):
    """``[K, N]`` int8 values in ``[-7, 7]``, N even -> ``[K, N/2]`` bytes:
    byte ``j`` holds column ``j`` in its low nibble and column ``j + N/2``
    in its high nibble."""
    if q.shape[1] % 2:
        raise ValueError("pack_int4_halves needs an even column count")
    half = q.shape[1] // 2
    lo = q[:, :half].to(torch.int32) & 0xF
    hi = q[:, half:].to(torch.int32) & 0xF
    return (lo | (hi << 4)).to(torch.uint8).view(torch.int8)


def unpack_int4_halves(packed):
    """Inverse of :func:`pack_int4_halves`: ``[K, N/2]`` bytes -> ``[K, N]``
    int8, each nibble sign-extended."""
    b = packed.to(torch.int32)
    lo = b & 0xF
    hi = (b >> 4) & 0xF
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    return torch.cat([lo, hi], dim=1).to(torch.int8)


# -- plain versions ---------------------------------------------------------------

def _check_int8(x, w_q, scales):
    if w_q.dtype != torch.int8:
        raise ValueError(f"weight must be int8, got {w_q.dtype}")
    k, n = w_q.shape
    if x.shape[-1] != k:
        raise ValueError(f"x [..., {x.shape[-1]}] does not contract with "
                         f"weight [{k}, {n}]")
    if scales.dim() == 2:
        if k % scales.shape[0]:
            raise ValueError(f"grouped scales rows {scales.shape[0]} must "
                             f"divide K={k}")
        if scales.shape[1] != n:
            raise ValueError(f"grouped scales {tuple(scales.shape)} must have "
                             f"{n} columns")
    elif scales.shape != (n,):
        raise ValueError(f"scales must be [{n}] or [K/G, {n}], got "
                         f"{tuple(scales.shape)}")


def _check_int4(x, w_packed, scales):
    if w_packed.dtype != torch.int8:
        raise ValueError(f"packed weight must be int8 bytes, got "
                         f"{w_packed.dtype}")
    k, half = w_packed.shape
    n = 2 * half
    if scales.shape[0] != n:
        raise ValueError(f"scales must cover {n} columns, got "
                         f"{scales.shape[0]}")
    if x.shape[-1] != k:
        raise ValueError(f"x [..., {x.shape[-1]}] does not contract with "
                         f"packed weight [{k}, {half}]")


def wo_int8_matmul_plain(x, w_q, scales):
    """What ``_wo_kernel`` / ``_wo_g_kernel`` compute, in plain PyTorch:
    per-channel ``(x @ w)_f32 * s`` cast once; grouped ``x @ bf16(w * s)``
    (the dequantized weight rounded to ``x.dtype`` first) cast once."""
    _check_int8(x, w_q, scales)
    xf = x.float()
    if scales.dim() == 2:
        wd = dequant_grouped(w_q, scales).to(x.dtype).float()
        return (xf @ wd).to(x.dtype)
    return ((xf @ w_q.float()) * scales.float()).to(x.dtype)


def wo_int4_matmul_plain(x, w_packed, scales):
    """What ``_wo4_kernel`` computes: the nibbles unpacked, then the
    per-channel product of :func:`wo_int8_matmul_plain`."""
    _check_int4(x, w_packed, scales)
    return wo_int8_matmul_plain(x, unpack_int4_halves(w_packed), scales)


# -- CUDA wrappers ------------------------------------------------------------------

def unsupported_reason(x2, w, scales, int4=False):
    """Why the CUDA kernels do not take these 2-D operands, or ``None``."""
    k = w.shape[0]
    n = 2 * w.shape[1] if int4 else w.shape[1]
    if x2.dtype != torch.bfloat16:
        return (f"activations of dtype {x2.dtype}: the card path takes "
                f"bfloat16 (the TPU kernel also takes float32)")
    if k % 8:
        return f"K={k} (takes multiples of 8: rows move as 16-byte vectors)"
    if n % (32 if int4 else 16):
        return (f"N={n} (takes multiples of {32 if int4 else 16}: weight rows "
                f"move as 16-byte vectors)")
    if max(x2.shape[0], k, n) >= 2 ** 31 // 2:
        return f"dims {(x2.shape[0], k, n)} past the kernel's int range"
    if any(t.device != x2.device for t in (w, scales)):
        return "operands on different devices"
    return None


def _launch(name, symbol, args, x2, w, scales, n, *extra):
    y = torch.empty(x2.shape[0], n, dtype=x2.dtype, device=x2.device)
    _build.require_aligned(name, x2, w, scales, y)
    fn = _build.function("wo_matmul", symbol, args)
    err = fn(x2.data_ptr(), w.data_ptr(), scales.data_ptr(), y.data_ptr(),
             x2.shape[0], n, w.shape[0], *extra, _build.stream_of(x2))
    _build.check(err, name)
    return y


def _operands(x2, w, scales, int4=False):
    if x2.device.type != "cuda":
        raise ValueError(f"weight-only matmul: no kernel for device "
                         f"{x2.device}")
    why = unsupported_reason(x2, w, scales, int4)
    if why is not None:
        raise ValueError(f"weight-only kernel does not take {why}")
    return (x2.contiguous(), w.contiguous(),
            scales.to(torch.float32).contiguous())


def wo_int8(x2, w_q, scales):
    """``[M, K]`` bf16 @ int8 ``[K, N]`` * per-channel ``scales [N]`` on the
    card (``_wo_kernel``); a CPU tensor takes the plain version."""
    if x2.device.type == "cpu":
        return wo_int8_matmul_plain(x2, w_q, scales)
    x2, w_q, scales = _operands(x2, w_q, scales)
    y = _launch("wo_int8", "ptt_wo_int8", _ARGS, x2, w_q, scales,
                w_q.shape[1])
    wo_int8.launches += 1
    return y


def wo_int8_grouped(x2, w_q, scales):
    """``[M, K]`` bf16 @ int8 ``[K, N]`` with grouped ``scales [K/G, N]`` on
    the card (``_wo_g_kernel``); a CPU tensor takes the plain version."""
    if x2.device.type == "cpu":
        return wo_int8_matmul_plain(x2, w_q, scales)
    x2, w_q, scales = _operands(x2, w_q, scales)
    y = _launch("wo_int8_grouped", "ptt_wo_int8_grouped", _ARGS_G, x2, w_q,
                scales, w_q.shape[1], w_q.shape[0] // scales.shape[0])
    wo_int8_grouped.launches += 1
    return y


def wo_int4(x2, w_packed, scales):
    """``[M, K]`` bf16 @ packed int4 ``[K, N/2]`` * ``scales [N]`` on the
    card (``_wo4_kernel``); a CPU tensor takes the plain version."""
    if x2.device.type == "cpu":
        return wo_int4_matmul_plain(x2, w_packed, scales)
    x2, w_packed, scales = _operands(x2, w_packed, scales, int4=True)
    y = _launch("wo_int4", "ptt_wo_int4", _ARGS, x2, w_packed, scales,
                2 * w_packed.shape[1])
    wo_int4.launches += 1
    return y


wo_int8.launches = 0
wo_int8_grouped.launches = 0
wo_int4.launches = 0


def wo_int8_matmul(x, w_q, scales):
    """``[.., K] @ int8 [K, N] * scales -> [.., N]`` in ``x.dtype``;
    ``scales`` is ``[N]`` (per output channel) or ``[K/G, N]`` (grouped).
    A CPU tensor takes :func:`wo_int8_matmul_plain`; a CUDA tensor launches
    :func:`wo_int8` or :func:`wo_int8_grouped`, or raises."""
    _check_int8(x, w_q, scales)
    lead, k = x.shape[:-1], w_q.shape[0]
    fn = wo_int8_grouped if scales.dim() == 2 else wo_int8
    return fn(x.reshape(-1, k), w_q, scales).reshape(*lead, w_q.shape[1])


def wo_int4_matmul(x, w_packed, scales):
    """``[.., K] @ int4-packed [K, N/2] * scales [N] -> [.., N]`` in
    ``x.dtype`` (halves layout). A CPU tensor takes
    :func:`wo_int4_matmul_plain`; a CUDA tensor launches :func:`wo_int4`
    or raises."""
    _check_int4(x, w_packed, scales)
    lead, k = x.shape[:-1], w_packed.shape[0]
    return wo_int4(x.reshape(-1, k), w_packed, scales).reshape(
        *lead, 2 * w_packed.shape[1])
