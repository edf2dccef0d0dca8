"""A8W8 matrix product: per-row dynamic int8 activations x int8 weights,
int32 contraction, dequant epilogue. CUDA kernel and plain version
(counterpart of ``paddle_tpu/ops/kernels/a8w8_matmul_pallas.py``).

Replaces ``_kernel`` (:50), reached through ``a8w8_matmul`` (:75), which
``nn.quant.llm_int8_linear`` calls at prefill shapes (:func:`use_kernel`,
the JAX rule). Source: ``paddle_tpu_torch/csrc/a8w8_matmul.cu``.

The function, bit for bit in the kernel and the plain version::

    s   = max(rowmax(|f32(x)|), 1e-6) / 127            per row, f32
    q   = clip(round_half_even(x / s), -127, 127)      int8 (IEEE division)
    acc = q . w                                        exact integers
    y   = ((f32(acc) * s) * ws[n]).to(x.dtype)

``layout`` "kn" takes ``w [K, N]``; "nk" takes ``w [N, K]`` (the
``llm_int8_linear`` storage), contracted without a transpose in memory.

What bounds it on the H100: operations at the int8 tensor-core rate (1979
TOPS; 0.061 ms for ``[1024, 4096] x [4096, 14336]``). The kernel runs as
two launches of one source: a quantize pass that writes ``s [M]`` and
``q [M, K]`` (the row max needs the whole K row; the TPU kernel recomputes
it per column block), a block a row reading the row once, then
``a8w8_wgmma_kernel``: a TMA ring of q's and the K-major weight's
128-byte swizzled boxes feeding ``wgmma`` m64n256k32 s8 (two consumer
warpgroups, one producer warp, a 128 x 256 output tile a block) with the
f32 epilogue. 8-bit wgmma operands must be K-major, so a "kn" weight is
first transposed into a K-major scratch copy (a third launch). The
wrapper counts one launch per call. The card path takes bf16
activations; a CPU tensor takes the plain version, a CUDA tensor launches
the kernel or raises. Inference only, as in the JAX package.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["a8w8_matmul", "a8w8_matmul_plain", "use_kernel",
           "unsupported_reason"]

_Q_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
_G_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2

# The launch plans of csrc/a8w8_matmul.cu (the tests hold them against its
# constants): the row quantization a 128-thread block a row; the
# product a [_BM, _BN] tile a block of _THREADS threads over a ring of
# _STAGES stages of q's [_BM, _BK] and the weight's [_BN, _BK] int8 boxes;
# the "kn" transpose a [_TILE, _TILE] byte tile a block of 256 threads.
_QUANT_THREADS, _QUANT_VECS = 128, 8
_BM, _BN, _BK, _THREADS, _STAGES = 128, 256, 128, 288, 4
_SMEM = 1024 + _STAGES * (_BM + _BN) * _BK + 2 * _STAGES * 8
_TILE = 64


def use_kernel(m, k) -> bool:
    """Prefill regime only (``a8w8_matmul_pallas.py:112-115``): enough rows
    that the int8 tensor-core rate matters."""
    return m >= 128 and k >= 256


def _dims(w_q, layout):
    if layout not in ("kn", "nk"):
        raise ValueError(f"layout must be 'kn' or 'nk', got {layout!r}")
    return (w_q.shape[1], w_q.shape[0]) if layout == "nk" else tuple(w_q.shape)


def _check(x, w_q, w_scales, layout):
    if w_q.dtype != torch.int8:
        raise ValueError(f"weight must be int8, got {w_q.dtype}")
    k, n = _dims(w_q, layout)
    if x.shape[-1] != k:
        raise ValueError(f"x [..., {x.shape[-1]}] does not contract with "
                         f"{layout} weight {tuple(w_q.shape)}")
    if w_scales.numel() != n:
        raise ValueError(f"w_scales must hold {n} values, got "
                         f"{w_scales.numel()}")
    return k, n


def row_quantize(x2):
    """``(q, s)``: the per-row int8 activations as f32 integers and the f32
    row scales ``[M, 1]``, as the TPU kernel computes them."""
    xf = x2.float()
    s = xf.abs().amax(dim=1, keepdim=True).clamp_min(1e-6) / 127.0
    return torch.clamp(torch.round(xf / s), -127.0, 127.0), s


def a8w8_matmul_plain(x, w_q, w_scales, layout="kn"):
    """The same function in plain PyTorch (``reference_a8w8``,
    ``a8w8_matmul_pallas.py:118-129``, with both layouts). The integer
    contraction runs in float64, where every sum of int8 products is
    exact, as the kernel's int32 one is."""
    k, n = _check(x, w_q, w_scales, layout)
    lead = x.shape[:-1]
    q, s = row_quantize(x.reshape(-1, k))
    w = w_q.double()
    acc = (q.double() @ (w.t() if layout == "nk" else w)).float()
    out = acc * s * w_scales.reshape(1, n).float()
    return out.to(x.dtype).reshape(*lead, n)


def unsupported_reason(x2, w_q, layout="kn"):
    """Why the CUDA kernel does not take these operands, or ``None``."""
    k, n = _dims(w_q, layout)
    if x2.dtype != torch.bfloat16:
        return (f"activations of dtype {x2.dtype}: the card path takes "
                f"bfloat16 (the TPU kernel also takes float32)")
    if k % 16:
        return f"K={k} (takes multiples of 16: rows move as 16-byte vectors)"
    if layout == "kn" and n % 16:
        return f"N={n} with layout 'kn' (takes multiples of 16)"
    if max(x2.shape[0], k, n) >= 2 ** 31 // 2:
        return f"dims {(x2.shape[0], k, n)} past the kernel's int range"
    return None


def a8w8_matmul(x, w_q, w_scales, layout="kn"):
    """``[.., K]`` float @ int8 weight -> ``[.., N]`` in ``x.dtype``,
    contracted in int8 with per-row dynamic activation scales and
    per-channel weight scales ``[N]``. A CPU tensor takes
    :func:`a8w8_matmul_plain`; a CUDA tensor launches the kernel or
    raises."""
    k, n = _check(x, w_q, w_scales, layout)
    if any(t.device != x.device for t in (w_q, w_scales)):
        raise ValueError("a8w8_matmul: operands on different devices")
    if x.device.type == "cpu":
        return a8w8_matmul_plain(x, w_q, w_scales, layout)
    if x.device.type != "cuda":
        raise ValueError(f"a8w8_matmul: no kernel for device {x.device}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    why = unsupported_reason(x2, w_q, layout)
    if why is not None:
        raise ValueError(f"a8w8 kernel does not take {why}")
    w_q = w_q.contiguous()
    ws = w_scales.reshape(n).to(torch.float32).contiguous()
    m = x2.shape[0]
    q = torch.empty(m, k, dtype=torch.int8, device=x.device)
    s = torch.empty(m, dtype=torch.float32, device=x.device)
    y = torch.empty(m, n, dtype=x.dtype, device=x.device)
    # the K-major copy of a "kn" weight (8-bit wgmma operands are K-major)
    wt = torch.empty(n, k, dtype=torch.int8, device=x.device) \
        if layout == "kn" else None
    _build.require_aligned("a8w8_matmul", x2, w_q, ws, q, s, y, wt)
    _launch(x2, w_q, ws, q, s, y, layout, _build.stream_of(x2), wt)
    a8w8_matmul.launches += 1
    return y.reshape(*lead, n)


a8w8_matmul.launches = 0


def _launch(x2, w_q, ws, q, s, y, layout, stream, wt=None):
    """Both C entries (row quantization, then the int8 product, which
    transposes a "kn" weight into ``wt [N, K]`` first) on operands the
    caller allocated."""
    m, k = x2.shape
    quant = _build.function("a8w8_matmul", "ptt_a8w8_quantize", _Q_ARGS)
    _build.check(quant(x2.data_ptr(), q.data_ptr(), s.data_ptr(), m, k,
                       stream), "a8w8_matmul quantize")
    gemm = _build.function("a8w8_matmul", "ptt_a8w8_gemm", _G_ARGS)
    _build.check(gemm(q.data_ptr(), s.data_ptr(), w_q.data_ptr(),
                      ws.data_ptr(), y.data_ptr(), m, y.shape[1], k,
                      int(layout == "nk"),
                      None if wt is None else wt.data_ptr(), stream),
                 "a8w8_matmul")


# -- declared launches for the kernel analyzer -------------------------------

def _ex(label, m, k, n, layout):
    """The row quantization (a block a row: q's row and its scale), for
    "kn" the weight's transpose into a K-major scratch
    copy (a 64 x 64 byte tile a block), then the product (a block a [128,
    256] output tile, 288 threads, the ring in dynamic shared memory)."""
    from ._examples import model, uniform
    mm = model()
    w_shape = (n, k) if layout == "nk" else (k, n)
    ops = [mm.Operand("x", (m, k), torch.bfloat16),
           mm.Operand("w", w_shape, torch.int8),
           mm.Operand("ws", (n,), torch.float32,
                      data=uniform((n,), torch.float32, 1e-4, 2.1e-3)),
           mm.Operand("q", (m, k), torch.int8, "out"),
           mm.Operand("s", (m,), torch.float32, "out"),
           mm.Operand("y", (m, n), torch.bfloat16, "out")]
    kernels = [
        mm.KernelLaunch("a8w8_quantize_kernel", m, _QUANT_THREADS,
                        writes=[mm.rows_map("q", m, k),
                                mm.TileMap("s", (1,), lambda x, y, z: (x,))],
                        reads=[mm.rows_map("x", m, k)])]
    if layout == "kn":
        ops.append(mm.Operand("wt", (n, k), torch.int8, "out"))
        kernels.append(mm.KernelLaunch(
            "a8w8_transpose_kernel", (-(-n // _TILE), -(-k // _TILE)), 256,
            writes=[mm.TileMap("wt", (_TILE, _TILE),
                               lambda x, y, z: (x, y))],
            reads=[mm.TileMap("w", (_TILE, _TILE), lambda x, y, z: (y, x))]))
    kernels.append(mm.KernelLaunch(
        "a8w8_wgmma_kernel", (-(-m // _BM), -(-n // _BN)), _THREADS,
        smem=_SMEM,
        writes=[mm.TileMap("y", (_BM, _BN), lambda x, y, z: (x, y))]))

    def plain(t):
        q, s = row_quantize(t["x"])
        out = {"q": q.to(torch.int8), "s": s.reshape(-1),
               "y": a8w8_matmul_plain(t["x"], t["w"], t["ws"], layout)}
        if layout == "kn":
            out["wt"] = t["w"].t().contiguous()
        return out

    def launch(t, stream):
        _launch(t["x"], t["w"], t["ws"], t["q"], t["s"], t["y"], layout,
                stream, t.get("wt"))

    return mm.Example(label, "a8w8_matmul", ops, kernels, launch, plain,
                      flops=2 * m * k * n,
                      nbytes=2 * m * k + n * k + 4 * n + 2 * m * n,
                      unit="int8", tol={"q": 1 / 127, "s": 1e-6,
                                        "y": 2.0 ** -7})


def ck_examples():
    """At ``a8w8_matmul_pallas.pk_examples``' shapes (x [512, 1024] @ [1024,
    2048], both layouts) and phase 3's (the llm_int8 prefill [1024, 4096] @
    nk [14336, 4096], and the same product with a "kn" weight); tails with
    M, N and K past their last full tile."""
    from ._examples import with_tail
    return [with_tail(_ex, label, dict(m=m, k=k, n=n, layout=layout),
                      dict(m=37, k=1040, n=1008, layout=layout))
            for label, m, k, n, layout in (
                ("a8w8_kn", 512, 1024, 2048, "kn"),
                ("a8w8_nk", 512, 1024, 2048, "nk"),
                ("phase3 [1024, 4096] @ nk [14336, 4096]", 1024, 4096, 14336,
                 "nk"),
                ("phase3 [1024, 4096] @ kn [4096, 14336]", 1024, 4096, 14336,
                 "kn"))]
