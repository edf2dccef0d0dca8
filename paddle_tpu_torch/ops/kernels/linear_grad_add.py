"""Linear weight-gradient accumulation ``acc += x^T dy``: the CUDA kernel
and its plain version.

Replaces ``paddle_tpu/ops/kernels/linear_grad_add_pallas.py``
``_grad_acc`` (:66; kernel body ``_kernel`` :47), reached through
``linear_grad_acc`` (:99). Source:
``paddle_tpu_torch/csrc/linear_grad_add.cu``.

``acc [K, N] += x2 [M, K]^T @ dy2 [M, N]``: the bf16 products are exact in
f32 and summed in f32, and the accumulator (f32 for ``main_grad``, or
bf16) is read once and written once in its own dtype. The product is the
TPU kernel's body, so the port's kernel is written by hand;
``torch.matmul`` is only its plain version and, in ``chip_smoke.py``, its
yardstick.

Unlike JAX, which returns a new array, the kernel updates ``acc`` in place
and returns it, as the reference op and the port's AdamW do. And unlike
JAX's dispatch, which sends products under 2**20 multiply-adds to its
composite (``use_kernel``, :104-108), the wrapper launches the kernel for
every size on the card.

What bounds it on the H100: operations at GPT-2's and Llama's widths. One
block of 8 warps owns a 128 x 128 output tile for the whole M sweep, with
a cp.async double buffer and mma.sync on the bf16 tensor cores. The card
path takes bf16 ``x`` and ``dy`` with ``K % 8 == 0`` and ``N % 8 == 0``,
any ``M``, and a contiguous f32 or bf16 ``acc``, and raises otherwise. A
CPU tensor takes the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["linear_grad_add", "linear_grad_add_plain"]

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _check(x2, dy2, acc):
    if x2.dim() != 2 or dy2.dim() != 2 or acc.dim() != 2:
        raise ValueError(f"linear_grad_add takes x [M, K], dy [M, N] and acc "
                         f"[K, N], got {tuple(x2.shape)}, {tuple(dy2.shape)}, "
                         f"{tuple(acc.shape)}")
    m, k = x2.shape
    if dy2.shape[0] != m or acc.shape != (k, dy2.shape[1]):
        raise ValueError(f"linear_grad_add: x {tuple(x2.shape)}, dy "
                         f"{tuple(dy2.shape)} and acc {tuple(acc.shape)} do "
                         f"not fit")
    if not (x2.is_floating_point() and dy2.is_floating_point()
            and acc.is_floating_point()):
        raise TypeError(f"linear_grad_add takes floating tensors, got "
                        f"{x2.dtype}, {dy2.dtype}, {acc.dtype}")
    if dy2.device != x2.device or acc.device != x2.device:
        raise ValueError("linear_grad_add: operands on different devices")


def linear_grad_add_plain(x2, dy2, acc):
    """``acc += x2^T dy2`` in plain PyTorch, as ``reference_grad_acc``
    (:111-116): an f32 product, added to the f32 accumulator, one cast to
    its dtype. Updates ``acc`` in place and returns it."""
    _check(x2, dy2, acc)
    part = x2.float().t() @ dy2.float()
    return acc.copy_((acc.float() + part).to(acc.dtype))


def linear_grad_add(x2, dy2, acc):
    """``acc += x2^T dy2`` in place, as :func:`linear_grad_add_plain`. A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (bf16 x and dy, K and N multiples of 8, a contiguous f32 or bf16 acc)
    or raises."""
    _check(x2, dy2, acc)
    if x2.device.type == "cpu":
        return linear_grad_add_plain(x2, dy2, acc)
    if x2.device.type != "cuda":
        raise ValueError(f"linear_grad_add: no kernel for device {x2.device}")
    if x2.dtype != torch.bfloat16 or dy2.dtype != torch.bfloat16 \
            or acc.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"linear_grad_add kernel takes bf16 x and dy and an "
                        f"f32 or bf16 acc, got {x2.dtype}, {dy2.dtype}, "
                        f"{acc.dtype}")
    m, k = x2.shape
    n = dy2.shape[1]
    if k % 8 or n % 8:
        raise ValueError(f"linear_grad_add kernel needs K % 8 == 0 and "
                         f"N % 8 == 0, got K={k}, N={n}")
    if max(m, k, n) >= 2 ** 31:
        raise ValueError(f"linear_grad_add: dims {(m, k, n)} past the "
                         f"kernel's int range")
    if not acc.is_contiguous():
        raise ValueError("linear_grad_add kernel updates a contiguous acc "
                         "in place")
    x2, dy2 = x2.contiguous(), dy2.contiguous()
    _build.require_aligned("linear_grad_add", x2, dy2, acc)
    _launch(x2, dy2, acc, _build.stream_of(x2))
    linear_grad_add.launches += 1
    return acc


linear_grad_add.launches = 0


def _launch(x2, dy2, acc, stream):
    """The C entry on operands the caller allocated."""
    m, k = x2.shape
    fn = _build.function("linear_grad_add", "ptt_linear_grad_add", _ARGS)
    err = fn(x2.data_ptr(), dy2.data_ptr(), acc.data_ptr(), m, k,
             dy2.shape[1], int(acc.dtype == torch.float32), stream)
    _build.check(err, "linear_grad_add")


# -- declared launches for the kernel analyzer -------------------------------

_TILE, _THREADS = 128, 256


def _ex(label, m, k, n, acc_dtype):
    """A block a [128, 128] tile of the accumulator (grid N / 128, K /
    128), updated in place after its K-by-M contraction."""
    from ._examples import CTYPE, model, normal
    mm = model()
    ops = [mm.Operand("x", (m, k), torch.bfloat16),
           mm.Operand("dy", (m, n), torch.bfloat16),
           mm.Operand("acc", (k, n), acc_dtype, "inout",
                      data=normal((k, n), acc_dtype, 4.0))]

    def plain(t):
        return {"acc": linear_grad_add_plain(t["x"], t["dy"], t["acc"])}

    def launch(t, stream):
        _launch(t["x"], t["dy"], t["acc"], stream)

    kern = mm.KernelLaunch(
        f"linear_grad_add_kernel<{CTYPE[acc_dtype]}>",
        (-(-n // _TILE), -(-k // _TILE)), _THREADS,
        writes=[mm.TileMap("acc", (_TILE, _TILE), lambda x, y, z: (y, x))])
    esz = acc_dtype.itemsize
    return mm.Example(label, "linear_grad_add", ops, [kern], launch, plain,
                      flops=2 * m * k * n,
                      nbytes=2 * (m * k + m * n) + 2 * esz * k * n,
                      unit="bf16", tol=1e-4 if esz == 4 else 2.0 ** -7)


def ck_examples():
    """At ``linear_grad_add_pallas.pk_examples``' shape (x [512, 1024], dy
    [512, 2048] into f32 [1024, 2048]) and phase 3's (GPT-2 small's
    ``mlp.fc`` into f32 and bf16, Llama-3-8B's gate into f32); tails with
    K and N past their last full tile and an odd M."""
    from ._examples import with_tail
    return [with_tail(_ex, label, dict(m=m, k=k, n=n, acc_dtype=dt),
                      dict(m=37, k=136, n=264, acc_dtype=dt))
            for label, m, k, n, dt in (
                ("grad_acc", 512, 1024, 2048, torch.float32),
                ("phase3 x [8192, 768] dy [8192, 3072] f32", 8192, 768, 3072,
                 torch.float32),
                ("phase3 x [4096, 4096] dy [4096, 14336] f32", 4096, 4096,
                 14336, torch.float32),
                ("phase3 x [8192, 768] dy [8192, 3072] bf16", 8192, 768, 3072,
                 torch.bfloat16))]
