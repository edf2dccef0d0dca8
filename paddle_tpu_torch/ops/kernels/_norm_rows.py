"""The launch plan of the two forward kernels that add into a residual row
and normalise it, RMSNorm (``rms_norm.py``) and the block epilogue
(``block_epilogue.py``): the Python side of ``csrc/norm_rows.cuh``.

:func:`plan` decides each launch from the shapes alone, and the C entries
launch exactly that (they refuse a launch that does not cover every row and
8-element vector). A block takes a row:

- ``ROW``: the row in its threads' registers, a vector of 8 a thread, all
  of its loads before its first reduction;
- ``WIDE``: rows past 8192, and the epilogue's variants with an activation
  or dropout, the threads striding over the row with the f32 row in shared
  memory between the two passes.

The C side takes the plan as one 64-bit word (:attr:`Plan.word`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

__all__ = ["ROW", "WIDE", "Plan", "make", "plan", "declare", "MAX_THREADS",
           "REG_HIDDEN", "WIDE_HIDDEN"]

ROW, WIDE = 0, 1
#: norm_rows.cuh's kMaxThreads, kRegHidden and kWideHidden (the wide arm's
#: f32 row beside 128 bytes of static scratch in the 232448 bytes a block
#: may take)
MAX_THREADS = 1024
REG_HIDDEN = 8 * MAX_THREADS
WIDE_HIDDEN = (232448 - 128) // 4 // 8 * 8


class Plan(NamedTuple):
    """One launch: ``blocks`` blocks of ``threads``, the arm, and
    ``word``, all of it as the C entries take it."""
    arm: int
    threads: int
    blocks: int
    word: int


def make(arm: int, rows: int, hidden: int) -> Plan:
    """The launch of ``arm`` at ``[rows, hidden]``: a block a row of the
    fewest whole warps that give each vector of 8 a thread (the wide arm:
    at most 1024, which stride over the row)."""
    threads = max(32, -(-(hidden // 8) // 32) * 32)
    if arm == WIDE:
        threads = min(MAX_THREADS, threads)
    return Plan(arm, threads, rows, threads | arm << 16 | rows << 20)


@functools.lru_cache(maxsize=None)
def plan(rows: int, hidden: int, in_registers: bool = True) -> Plan:
    """The launch at ``[rows, hidden]``: a block a row in registers up to
    :data:`REG_HIDDEN` where the kernel's variant is held there
    (``in_registers``), else the wide arm."""
    return make(ROW if in_registers and hidden <= REG_HIDDEN else WIDE,
                rows, hidden)


def declare(m, kernel, p: Plan, rows: int, hidden: int, writes, reads,
            whole=()):
    """The :class:`KernelLaunch` of plan ``p`` for the analysis tier
    (``m``: its model module): ``kernel`` is the kernel's name and template
    arguments but the arm, which is appended; each operand of ``writes``
    and ``reads`` is ``(name, width)``, a ``[rows, width]`` row operand a
    block reaches one row of; ``whole`` names the ``[hidden]`` vectors
    every block reads."""
    return m.KernelLaunch(
        f"{kernel[:-1]},{p.arm}>", p.blocks, p.threads,
        smem=4 * hidden if p.arm == WIDE else 0,
        writes=[m.rows_map(op, rows, w) for op, w in writes],
        reads=[m.rows_map(op, rows, w) for op, w in reads]
        + [m.whole_map(op, (hidden,)) for op in whole])
