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

What bounds it on the H100: operations at GPT-2's and Llama's widths. A
block owns a 256 x 128 output tile: a producer warp keeps TMA loads of
x's and dy's 64-token tiles in flight into a four-stage ring, and two
consumer warpgroups run ``wgmma`` with both operands MN-major (the tokens
are the reduction). Where the output tiles alone would leave the card
idle, the token sweep is split over the 2, 4 or 8 blocks of a cluster,
whose partial tiles are added in rank order through distributed shared
memory before the accumulator is read and written once; an unsplit tile
into an f32 accumulator is added into it by one TMA reduce-add in L2 an
element. Each element of ``acc`` has one contributor, so two calls give
the same bits. The card path takes bf16 ``x`` and ``dy`` with ``K % 8 ==
0`` and ``N % 8 == 0``, any ``M``, and a contiguous f32 or bf16 ``acc``,
and raises otherwise. A CPU tensor takes the plain version.
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
    _build.check(fn(x2.data_ptr(), dy2.data_ptr(), acc.data_ptr(), m, k,
                    dy2.shape[1], int(acc.dtype == torch.float32), stream),
                 "linear_grad_add")


# -- declared launches for the kernel analyzer -------------------------------

# the launch constants of csrc/linear_grad_add.cu
# (tests/test_torch_grad_acc_hopper.py holds them against the source)
_TK, _TN, _TM, _THREADS, _STAGES = 256, 128, 64, 288, 4
_SPLIT, _SMS, _FIXED_STEPS = 8, 132, 18
_SMEM = 1024 + _STAGES * (_TK // 64 + _TN // 64) * _TM * 128 + 2 * _STAGES * 8


def _cdiv(a, b):
    return -(-a // b)


def _split(m, k, n):
    """``grad_split``: the cluster split (1, 2, 4 or 8) with the fewest
    waves of blocks times (64-token steps a block + its fixed cost); the
    smaller split on a tie."""
    tiles, steps = _cdiv(k, _TK) * _cdiv(n, _TN), _cdiv(m, _TM)
    costs = {s: _cdiv(tiles * s, _SMS) * (_cdiv(steps, s) + _FIXED_STEPS)
             for s in (1, 2, 4, 8)}
    return min(costs, key=lambda s: (costs[s], s))


def _plan(m, k, n):
    """(split, grid, 64-token steps a block) of one launch."""
    split = _split(m, k, n)
    return (split, (split, _cdiv(k, _TK), _cdiv(n, _TN)),
            _cdiv(_cdiv(m, _TM), split))


def _ex(label, m, k, n, acc_dtype):
    """Grid (split, K / 256, N / 128), a cluster of ``split`` blocks along
    x a [256, 128] tile of the accumulator: block r of the cluster writes
    its rows r (256 / split) .. (r + 1) (256 / split) - 1, after adding
    the cluster's partial sums."""
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

    split, grid, _ = _plan(m, k, n)
    rows = _TK // split

    def strip(x, y, z):            # a strip wholly past K writes nothing
        return [(y * split + x, z)] if (y * split + x) * rows < k else []
    kern = mm.KernelLaunch(
        f"grad_acc_kernel<{CTYPE[acc_dtype]}>", grid, _THREADS, smem=_SMEM,
        cluster=(split, 1, 1),
        writes=[mm.TileMap("acc", (rows, _TN), strip)])
    esz = acc_dtype.itemsize
    return mm.Example(label, "linear_grad_add", ops, [kern], launch, plain,
                      flops=2 * m * k * n,
                      nbytes=2 * (m * k + m * n) + 2 * esz * k * n,
                      unit="bf16", tol=1e-4 if esz == 4 else 2.0 ** -7)


#: the incubate path's four products at B 4 x S 1024 (GPT-2 small's
#: qkv, out, fc and proj weights), into f32 main_grads
INCUBATE_SHAPES = ((4096, 768, 2304), (4096, 768, 768), (4096, 768, 3072),
                   (4096, 3072, 768))


def ck_examples():
    """At ``linear_grad_add_pallas.pk_examples``' shape (x [512, 1024], dy
    [512, 2048] into f32 [1024, 2048]), phase 3's (GPT-2 small's
    ``mlp.fc`` into f32 and bf16, Llama-3-8B's gate into f32) and the
    incubate path's four products; tails with M, K and N past their last
    full tile at a split of 1 (x [37, 136]), 2 (x [1000, 1800], dy [1000,
    1000]) and 8 (x [2085, 264], dy [2085, 200]), and rows of a single
    token (x [1, 8], dy [1, 264])."""
    from ._examples import with_tail
    f32, bf = torch.float32, torch.bfloat16
    cases = [("grad_acc", 512, 1024, 2048, f32, (37, 136, 264)),
             ("phase3 x [8192, 768] dy [8192, 3072] f32", 8192, 768, 3072,
              f32, (2085, 264, 200)),
             ("phase3 x [4096, 4096] dy [4096, 14336] f32", 4096, 4096,
              14336, f32, (1000, 1800, 1000)),
             ("phase3 x [8192, 768] dy [8192, 3072] bf16", 8192, 768, 3072,
              bf, (2085, 264, 200))]
    tails = ((33, 136, 8), (1, 8, 264), (1000, 1800, 1000), (2085, 264, 200))
    for (m, k, n), tail in zip(INCUBATE_SHAPES, tails):
        cases.append((f"phase3 x [{m}, {k}] dy [{m}, {n}] f32", m, k, n, f32,
                      tail))
    return [with_tail(_ex, label, dict(m=m, k=k, n=n, acc_dtype=dt),
                      dict(m=tm, k=tk, n=tn, acc_dtype=dt))
            for label, m, k, n, dt, (tm, tk, tn) in cases]
