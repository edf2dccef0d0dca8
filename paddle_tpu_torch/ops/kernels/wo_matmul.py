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

What bounds the kernels on the H100: bytes in decode (M = 1..16 rows: the
weight is read once, 58.7 MB for Llama-3-8B's gate_proj at int8, 0.018 ms
at 3.35 TB/s), operations in prefill (M = 64..2048: 120 GFLOP for
gate_proj at M 1024, 0.12 ms at the 989 TFLOP/s bf16 tensor-core rate).
All three modes run two kernels (the CUDA source describes them) built
from ``csrc/hopper.cuh``: past 16 rows ``wo_prefill_kernel`` runs
``wgmma`` on x's TMA tile and a bf16 tile the consumers dequantise from
the int8 or packed int4 TMA tile in shared memory; up to 16 rows
``wo_decode_kernel`` streams the weight through a TMA ring into
``mma.sync`` (the weight as the A operand) and splits K over the blocks
of a cluster, whose partial sums are added in rank order through
distributed shared memory. A packed int4 tile is a box of [64 k, 64
bytes]: its low nibbles are 64 columns of y's first half, its high ones
the same 64 columns of the second half.

The card path takes bf16 activations only; f32 activations (the CPU
tests' dtype, which the TPU kernel also takes) raise on the card
(:func:`unsupported_reason`). A CPU tensor takes the plain version; a
CUDA tensor launches the kernel or raises. Nothing falls back to a
composite (the JAX package's ``_wo_dispatch`` does, with a warning).
"""

from __future__ import annotations

import ctypes
import math

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
    _call(name, symbol, args, x2, w, scales, y, extra, _build.stream_of(x2))
    return y


def _call(name, symbol, args, x2, w, scales, y, extra, stream):
    """A C entry on operands the caller allocated."""
    fn = _build.function("wo_matmul", symbol, args)
    err = fn(x2.data_ptr(), w.data_ptr(), scales.data_ptr(), y.data_ptr(),
             x2.shape[0], y.shape[1], w.shape[0], *extra, stream)
    _build.check(err, name)


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


# -- declared launches for the kernel analyzer -------------------------------

_MODES = {"wo_int8": 0, "wo_int8_grouped": 1, "wo_int4": 2}

# the launch constants of csrc/wo_matmul.cu (tests/test_torch_wo_hopper.py
# holds them against the source)
_SMEM_MAX, _BK, _BN = 232448, 64, 128
_PRE_THREADS, _PRE_STAGES, _PRE_CONV = 288, 6, 3
_DEC_THREADS, _DEC_STAGES, _DEC_SPLIT, _XROW = 160, 8, 8, 72
_SMS, _SMEM_SM, _DEC_BLOCKS8, _DEC_BLOCKS16 = 132, 233472, 3, 2


def _round_up(a, b):
    return -(-a // b) * b


def _scale_rows(g):
    """Scale rows of ``[K/G, N]`` a 64-row stage spans (``scale_rows``)."""
    if g % _BK == 0:
        return 1
    if _BK % g == 0:
        return _BK // g
    return min(_BK, (_BK - 1) // g + 2)


def _scale_bytes(grouped, srows):
    return _round_up(srows * _BN * 4, 1024) if grouped else 0


def _w_tile(mode, nc=_BN):
    """``w_tile``: weight bytes of a 64-row stage of ``nc`` columns (mode 0
    int8, 1 grouped int8, 2 packed int4: half a byte a column)."""
    return _BK * (nc // 2 if mode == 2 else nc)


def _prefill_plan(mode, m, n, srows):
    """``prefill_plan``: (BM, ring stages, dynamic shared memory); ``mode``
    as ``_MODES`` (False and True: int8 and grouped int8)."""
    def plan(bm):
        stage = bm * _BK * 2 + _w_tile(mode) + _scale_bytes(mode == 1, srows)
        fixed = 1024 + _PRE_CONV * _BK * _BN * 2 + 16 * _PRE_STAGES
        stages = min(_PRE_STAGES, (_SMEM_MAX - fixed) // stage)
        return bm, stages, fixed + stages * stage

    def waves(bm):
        return -(-(-(-m // bm) * -(-n // _BN)) // _SMS)
    tall = plan(256)
    return tall if 4 * waves(256) <= 3 * waves(128) and tall[1] >= 3 \
        else plan(128)


def _dec_blocks(tg, nc=_BN):
    """``dec_blocks``: decode blocks an SM."""
    return _DEC_BLOCKS8 if tg == 1 and nc == _BN else _DEC_BLOCKS16


def _decode_plan(mode, m, n, k, srows, nc=_BN):
    """``decode_plan``: (token groups of 8, K split = cluster size, k a
    block, ring stages, dynamic shared memory) for blocks of ``nc``
    output columns; ``mode`` as in :func:`_prefill_plan`."""
    tiles = -(-n // nc)
    tg = 2 if m > 8 else 1
    blocks = _dec_blocks(tg, nc)
    want = max(1, min(_DEC_SPLIT, blocks * _SMS // tiles))
    kslice = _round_up(-(-k // want), _BK)
    stage = _w_tile(mode, nc) + _scale_bytes(mode == 1, srows)
    x_stage = 8 * tg * _XROW * 2
    fixed = 1024 + 16 * _DEC_STAGES
    budget = _SMEM_SM // blocks - 1024
    stages = max(2, min(_DEC_STAGES, (budget - fixed) // (stage + x_stage)))
    ring = max(stages * stage, 5 * 8 * tg * nc * 4)
    return tg, -(-k // kslice), kslice, stages, fixed + ring + stages * x_stage


def _int4_dec_cols(m, n):
    """``int4_dec_cols``: 256 decode columns a block (a 128-byte box)
    where that grid's K split is not capped at ``_DEC_SPLIT`` (its tiles
    times the cap exceed its block slots), else 128."""
    tiles = -(-n // (2 * _BN))
    return 2 * _BN if tiles * _DEC_SPLIT > \
        _dec_blocks(2 if m > 8 else 1, 2 * _BN) * _SMS else _BN


def _wo_launch(mm, name, m_rows, k, n, group):
    """The launch of a weight-only kernel: past 16 rows one block a [BM,
    128] output tile; up to 16 rows a cluster of ``split`` blocks a tile
    of ``nc`` columns (int4: :func:`_int4_dec_cols`, else 128),
    block r writing the 16-column chunks r, r + split, .. of it. A packed
    int4 tile's first half of columns lies in y's first half, its second
    in y's second: y seen as [M, 2, N/2]."""
    mode = _MODES[name]
    srows = _scale_rows(group) if mode == 1 else 0
    int4 = mode == 2
    if m_rows > 16:
        bm, _, smem = _prefill_plan(mode, m_rows, n, srows)
        grid = (-(-m_rows // bm), -(-n // _BN))
        if int4:
            tile = mm.TileMap("y", (bm, 2, _BN // 2), lambda x, yb, z: (x, 0, yb),
                              view=(m_rows, 2, n // 2))
        else:
            tile = mm.TileMap("y", (bm, _BN), lambda x, yb, z: (x, yb))
        return mm.KernelLaunch(f"wo_prefill_kernel<{mode},{bm}>", grid,
                               _PRE_THREADS, smem=smem, writes=[tile])
    nc = _int4_dec_cols(m_rows, n) if int4 else _BN
    tg, split, _, _, smem = _decode_plan(mode, m_rows, n, k, srows, nc)
    chunks = nc // 16
    if int4:
        half = chunks // 2

        def idx(x, yb, z):
            out = []
            for c in range(x, chunks, split):
                col = yb * (nc // 2) + 16 * (c % half)
                if col < n // 2:
                    out.append((0, c // half, col // 16))
            return out
        tile = mm.TileMap("y", (m_rows, 1, 16), idx, view=(m_rows, 2, n // 2))
    else:
        tile = mm.TileMap("y", (m_rows, 16), lambda x, yb, z: [
            (0, chunks * yb + c) for c in range(x, chunks, split)
            if (chunks * yb + c) * 16 < n])
    return mm.KernelLaunch(
        f"wo_decode_kernel<{mode},{tg},{nc}>", (split, -(-n // nc)),
        _DEC_THREADS, smem=smem, cluster=(split, 1, 1), writes=[tile])


def _ex(label, name, m_rows, k, n, group=128):
    """One call of a weight-only entry; its launch is
    :func:`_wo_launch`'s."""
    from ._examples import model, uniform
    mm = model()
    bf = torch.bfloat16
    int4 = name == "wo_int4"
    w_shape = (k, n // 2) if int4 else (k, n)
    s_shape = (k // group, n) if name == "wo_int8_grouped" else (n,)
    ops = [mm.Operand("x", (m_rows, k), bf),
           mm.Operand("w", w_shape, torch.int8),
           mm.Operand("s", s_shape, torch.float32,
                      data=uniform(s_shape, torch.float32, 1e-4, 2.1e-3)),
           mm.Operand("y", (m_rows, n), bf, "out")]
    launch_decl = _wo_launch(mm, name, m_rows, k, n, group)
    symbol = "ptt_" + name
    args = _ARGS_G if name == "wo_int8_grouped" else _ARGS
    extra = (group,) if name == "wo_int8_grouped" else ()

    def plain(t):
        fn = wo_int4_matmul_plain if int4 else wo_int8_matmul_plain
        return {"y": fn(t["x"], t["w"], t["s"])}

    def launch(t, stream):
        _call(name, symbol, args, t["x"], t["w"], t["s"], t["y"], extra,
              stream)

    w_bytes = (k * n // 2 if int4 else k * n) + 4 * math.prod(s_shape)
    return mm.Example(label, "wo_matmul", ops, [launch_decl], launch, plain,
                      flops=2 * m_rows * k * n,
                      nbytes=w_bytes + 2 * m_rows * k + 2 * m_rows * n,
                      unit="bf16")


def ck_examples():
    """At ``wo_matmul_pallas.pk_examples``' shapes (x [8, 1024] @ [1024,
    4096], grouped at G 128, int4 packed [1024, 2048]) and phase 3's
    (Llama-3-8B's projections: decode [8, 4096] @ [4096, 14336] and [8,
    14336] @ [14336, 4096], prefill [1024, 4096] @ [4096, 14336] and the
    ragged [1531, 4096] @ [4096, 1024], each kernel); tails with M, N and K
    past their last full tile in both tilings."""
    from ._examples import with_tail
    out = []
    for name in ("wo_int8", "wo_int8_grouped", "wo_int4"):
        small = dict(name=name, m_rows=5, k=1032, n=1056, group=8)
        big = dict(small, m_rows=37)
        out.append(with_tail(_ex, name, dict(name=name, m_rows=8, k=1024,
                                             n=4096), small))
        for m_rows, k, n in ((8, 4096, 14336), (8, 14336, 4096),
                             (1024, 4096, 14336), (1531, 4096, 1024)):
            out.append(with_tail(_ex, f"phase3 {name} [{m_rows}, {k}, {n}]",
                                 dict(name=name, m_rows=m_rows, k=k, n=n),
                                 small if m_rows <= 16 else big))
    return out
