"""Planted CK faults: proof that every ERROR-severity rule fires.

The counterpart of ``paddle_tpu/analysis/kernels/demo.py`` (row 22 of the
port's kernel table): each plant is a CUDA kernel of
``paddle_tpu_torch/csrc/analysis_demo.cu`` that computes what its Pallas
body computes (``x + x``, a copy, ``x * (x[0, 0] * 2)``) at the JAX
example's shapes, with one planted fault, so that the analyzer's findings
map one to one onto the plants:

=====================  =============================================  ======
plant                  fault                                          rule
=====================  =============================================  ======
``vmem_overflow``      the whole [4096, 2048] f32 operand in dynamic   CK200
                       shared memory: 32 MiB, refused by the card
``overlapping_writes`` grid (2, 2); block (i, j) writes output tile j  CK201
``coverage_gap``       two blocks write output tiles 0-1 of 4          CK202
``oob_read``           four blocks read input tiles 0-3 of 2           CK203
``vmem_scalar_mulf``   none (Mosaic's scalar-mulf miscompile has no    —
                       nvcc counterpart: a deliberate difference)
``missing_check``      a wrapper that drops a C entry's return code    CK206
=====================  =============================================  ======

Running the module analyzes itself (errors expected; ``--device cpu``
for the declaration and source planes alone):

    python -m paddle_tpu_torch.analysis.kernels.demo [--device cpu]

On the card the runnable plants are launched inside guard bands:
``overlapping_writes`` and ``vmem_scalar_mulf`` equal their plain
versions, ``coverage_gap`` leaves the sentinel in rows 128-255,
``oob_read`` reads the poison past its input, and the card refuses
``vmem_overflow``'s launch.
"""

from __future__ import annotations

import ctypes
import inspect
import sys

import torch

from ...ops.kernels import _build
from .model import Example, KernelLaunch, Operand, TileMap

F32 = torch.float32
TILE_ROWS = 64            # every copy plant moves [64, cols] tiles
THREADS = 256
_DOUBLE_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p]
_TILES_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] \
    + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_PLANTS = {"overlapping_writes": 0, "coverage_gap": 1, "oob_read": 2,
           "vmem_scalar_mulf": 3}
_NO_TAIL = "the plant's C entry takes whole [64, cols] tiles only"
#: launches of each plant's kernel (counted once a launch is accepted)
LAUNCHES = dict.fromkeys(("vmem_overflow", *_PLANTS), 0)


def double_plain(x):
    """``x + x`` (``_double_kernel``)."""
    return x + x


def copy_plain(x, rows):
    """A copy of ``x`` into ``rows`` rows, zero past its end
    (``_copy_kernel``)."""
    out = torch.zeros(rows, x.shape[1], dtype=x.dtype, device=x.device)
    n = min(rows, x.shape[0])
    out[:n] = x[:n]
    return out


def scalar_plain(x):
    """``x * (x[0, 0] * 2)`` (``_vmem_scalar_kernel``)."""
    return x * (x[0, 0] * 2.0)


def vmem_overflow(t, stream):
    """CK200: the whole 32 MiB operand in one block's dynamic shared
    memory, past the 227 KB opt-in limit; the C entry returns the refusal
    of ``cudaFuncSetAttribute``."""
    fn = _build.function("analysis_demo", "ptt_demo_double", _DOUBLE_ARGS)
    _build.check(fn(t["x"].data_ptr(), t["o"].data_ptr(), t["x"].numel(),
                    stream), "vmem_overflow")
    LAUNCHES["vmem_overflow"] += 1


def _tiles(plant, grid):
    def launch(t, stream):
        fn = _build.function("analysis_demo", "ptt_demo_tiles", _TILES_ARGS)
        _build.check(fn(_PLANTS[plant], t["x"].data_ptr(), t["o"].data_ptr(),
                        grid[0], grid[1], t["x"].shape[1], stream), plant)
        LAUNCHES[plant] += 1
    launch.__name__ = plant
    return launch


def missing_check(x):
    """CK206 (source): launches the double kernel and drops its return
    code, so a refused launch goes unreported. Never launched; the source
    plane finds it."""
    o = torch.empty_like(x)
    fn = _build.function("analysis_demo", "ptt_demo_double", _DOUBLE_ARGS)
    fn(x.data_ptr(), o.data_ptr(), x.numel(), _build.stream_of(x))
    return o


def _line(fn) -> int:
    return inspect.getsourcelines(fn)[1]


def _label_line(label) -> int:
    """The line of ``ck_examples`` that declares plant ``label``."""
    src, start = inspect.getsourcelines(ck_examples)
    return start + next(i for i, s in enumerate(src) if f'"{label}"' in s)


def _tile_plant(label, kernel, grid, out_rows, src_of, dst_of, plain):
    """A copy-shaped plant: [128, 128] f32 in, ``out_rows`` rows out,
    block ``b`` reading input tile ``src_of(b)`` and writing output tile
    ``dst_of(b)``."""
    cols = 128
    launch = _tiles(label, grid)
    return Example(
        label=label, library="analysis_demo",
        operands=[Operand("x", (128, cols), F32),
                  Operand("o", (out_rows, cols), F32, "out")],
        kernels=[KernelLaunch(
            kernel, grid, THREADS,
            writes=[TileMap("o", (TILE_ROWS, cols),
                            lambda *b: (dst_of(*b), 0))],
            reads=[TileMap("x", (TILE_ROWS, cols),
                           lambda *b: (src_of(*b), 0))])],
        launch=launch, plain=plain, flops=0 if label != "vmem_scalar_mulf"
        else 128 * cols, nbytes=(128 + out_rows) * cols * 4, tol=0.0,
        tail=_NO_TAIL, line=_label_line(label))


def ck_examples():
    """The plants, at the JAX examples' shapes (``demo.py:111-121``)."""
    rows, cols = 4096, 2048
    n = rows * cols
    overflow = Example(
        label="vmem_overflow", library="analysis_demo",
        operands=[Operand("x", (rows, cols), F32),
                  Operand("o", (rows, cols), F32, "out")],
        kernels=[KernelLaunch(
            "demo_double_kernel", 1, THREADS, smem=4 * n,
            writes=[TileMap("o", (rows, cols), lambda *b: (0, 0))],
            reads=[TileMap("x", (rows, cols), lambda *b: (0, 0))])],
        launch=vmem_overflow, plain=lambda t: {"o": double_plain(t["x"])},
        flops=n, nbytes=2 * 4 * n, tol=0.0,
        tail="one block stages the whole operand: every shape is one tile",
        line=_line(vmem_overflow))
    return [
        overflow,
        _tile_plant("overlapping_writes", "demo_overlap_kernel", (2, 2), 128,
                    lambda bx, by, bz: by, lambda bx, by, bz: by,
                    lambda t: {"o": copy_plain(t["x"], 128)}),
        _tile_plant("coverage_gap", "demo_gap_kernel", (2, 1), 256,
                    lambda bx, by, bz: bx, lambda bx, by, bz: bx,
                    lambda t: {"o": copy_plain(t["x"], 256)}),
        _tile_plant("oob_read", "demo_oob_kernel", (4, 1), 256,
                    lambda bx, by, bz: bx, lambda bx, by, bz: bx,
                    lambda t: {"o": copy_plain(t["x"], 256)}),
        _tile_plant("vmem_scalar_mulf", "demo_scalar_kernel", (2, 1), 128,
                    lambda bx, by, bz: bx, lambda bx, by, bz: bx,
                    lambda t: {"o": scalar_plain(t["x"])}),
    ]


if __name__ == "__main__":
    from .__main__ import main
    print("analyzing the planted demo (errors EXPECTED):", file=sys.stderr)
    sys.exit(main([__file__, "--no-allowlist", *sys.argv[1:]]))
