"""Declared launch models: from ``ck_examples()`` to :class:`Example`\\ s.

The Pallas tier traces a ``pallas_call`` and reads its grid, block shapes
and index maps (``paddle_tpu/analysis/kernels/model.py:115-153``). A CUDA
launch has no such trace, so every kernel module of the port declares its
launches instead, in ``ck_examples()``, and the card plane
(:mod:`.guard`) proves each declaration on the card: the profiled launch
must have the declared grid, block and shared memory, and a launch inside
guard bands must write every declared tile and nothing outside its
operands.

An :class:`Example` is one call of a C entry on operands the caller
allocated: its operands (shape, dtype, role), the :class:`KernelLaunch`\\ es
it makes in stream order (the ``__global__`` function with its template
arguments, grid, block, dynamic shared memory, and a :class:`TileMap` for
each operand it writes and reads), the operation and byte counts its bound
is taken from, ``launch(tensors, stream)`` and the plain version. A
:class:`TileMap` is a Pallas ``BlockSpec`` for one kernel: a tile shape and
an index function of ``(blockIdx.x, .y, .z)``, which may name several
tiles (a grid-stride loop), so coverage, overlap and bounds are checked by
evaluating maps over the grid, as ``paddle_tpu/analysis/kernels/rules.py``
does.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import itertools
import math
import os
from typing import Any, Callable

__all__ = ["GRID_ENUM_CAP", "Operand", "TileMap", "KernelLaunch", "Example",
           "ExtractionNote", "extract_module", "load_kernel_module",
           "rows_map", "whole_map", "stride_map", "grid3"]

#: full grid enumeration (coverage / overlap / bounds) is capped here;
#: larger grids get corner-sampled bounds checks only, with a note
GRID_ENUM_CAP = 8192

ROLES = ("in", "out", "inout")


def grid3(g) -> tuple:
    """A grid or block as three ints (x, y, z)."""
    g = (g,) if isinstance(g, int) else tuple(g)
    return tuple(int(v) for v in g) + (1,) * (3 - len(g))


@dataclasses.dataclass
class Operand:
    """One tensor a C entry reads or writes."""
    name: str
    shape: tuple
    dtype: Any                   # torch.dtype
    role: str = "in"             # "in" | "out" | "inout"
    #: ``(generator, device) -> tensor`` for an input whose values matter
    #: (indices, tables, masks); ``None`` draws from a normal distribution
    data: Callable | None = None
    #: several blocks add into it with atomics (rule CK201 does not apply)
    accumulate: bool = False

    def __post_init__(self):
        self.shape = tuple(int(d) for d in self.shape)
        if self.role not in ROLES:
            raise ValueError(f"operand {self.name}: role {self.role!r} "
                             f"not in {ROLES}")

    @property
    def numel(self) -> int:
        return math.prod(self.shape)

    @property
    def nbytes(self) -> int:
        return self.numel * self.dtype.itemsize


@dataclasses.dataclass
class TileMap:
    """One operand's tiles as one kernel's blocks reach them: a tile shape
    over ``view`` (a reshape of the operand; its own shape by default)
    and ``index(bx, by, bz)``, the tile index, or a list of them."""
    operand: str
    block: tuple
    index: Callable
    view: tuple | None = None
    array_shape: tuple = ()      # bound by Example.bind

    def bind(self, op: Operand) -> None:
        shape = tuple(self.view) if self.view is not None else op.shape
        if math.prod(shape) != op.numel:
            raise ValueError(f"tile map of {op.name}: view {shape} does not "
                             f"hold the operand's {op.shape}")
        if len(self.block) != len(shape):
            raise ValueError(f"tile map of {op.name}: tile {self.block} "
                             f"and view {shape} differ in rank")
        self.array_shape = shape

    @property
    def nblocks(self) -> tuple:
        """Tiles per dim: ``ceil(dim / tile)``."""
        return tuple(max(1, math.ceil(a / b))
                     for a, b in zip(self.array_shape, self.block))

    @property
    def has_tail(self) -> bool:
        """Some dim is not a multiple of the tile: the last tile hangs
        past the operand's edge and the kernel must mask it."""
        return any(a % b for a, b in zip(self.array_shape, self.block))

    def eval_index(self, block_id) -> list:
        """The tile indices block ``block_id`` reaches (a list of tuples)."""
        idx = self.index(*block_id)
        if isinstance(idx, list):
            return [tuple(int(i) for i in t) for t in idx]
        return [tuple(int(i) for i in idx)]

    def element_slices(self, tile) -> tuple:
        """The slices of the view that ``tile`` covers, clipped to it."""
        return tuple(slice(min(t * b, a), min((t + 1) * b, a))
                     for t, b, a in zip(tile, self.block, self.array_shape))


@dataclasses.dataclass
class KernelLaunch:
    """One launch of a ``__global__`` function: its name as the compiler
    prints it demangled (template arguments included, no namespace),
    grid, block, dynamic shared memory, the tiles its blocks write and
    read, whether it is a cooperative launch, and its thread-block
    cluster (blocks a cluster along x, y, z; one by default).
    ``writes=None`` says its writes depend on the data (rule CK209 notes
    it; the guard plane still checks the bands and the result)."""
    kernel: str
    grid: tuple
    block: tuple
    smem: int = 0
    writes: list | None = dataclasses.field(default_factory=list)
    reads: list = dataclasses.field(default_factory=list)
    cooperative: bool = False
    cluster: tuple = (1, 1, 1)

    def __post_init__(self):
        self.grid = grid3(self.grid)
        self.block = grid3(self.block)
        self.cluster = grid3(self.cluster)

    @property
    def threads(self) -> int:
        return math.prod(self.block)

    @property
    def blocks(self) -> int:
        return math.prod(self.grid)

    @property
    def enumerable(self) -> bool:
        return self.blocks <= GRID_ENUM_CAP

    def block_ids(self):
        """Every ``(bx, by, bz)`` of the grid (x fastest)."""
        for bz, by, bx in itertools.product(*(range(g) for g in
                                              reversed(self.grid))):
            yield (bx, by, bz)


@dataclasses.dataclass
class Example:
    """One call of a C entry, declared (see the module docstring).

    ``launch(t, stream)`` takes the tensors by operand name and the stream
    handle and calls the C entry (its return code through
    ``_build.check``); ``plain(t)`` takes the same tensors, before the
    launch, and returns the expected value of every ``out`` and ``inout``
    operand by name; an operand named in ``reduce`` (partial sums a block
    each) is compared after ``reduce[name](value)``. ``tol`` is the
    largest error allowed, as a fraction of the largest expected magnitude
    (one bf16 ulp, 2**-7, by default), or a dict of it by operand name
    (``"*"`` for the rest).
    ``tail`` is the same call at a shape that is not a multiple of the
    kernel's tiles, or a string saying why the kernel accepts no such
    shape. ``flops`` and ``nbytes`` count the work of the whole call (each
    input read once, each output written once) on the units of ``unit``
    (``f32``, ``bf16`` or ``int8``)."""
    label: str
    library: str
    operands: list
    kernels: list
    launch: Callable
    plain: Callable
    flops: float
    nbytes: float
    unit: str = "f32"
    tol: Any = 2.0 ** -7
    tail: Any = None
    file: str = ""
    line: int = 0
    reduce: dict = dataclasses.field(default_factory=dict)
    #: ``prepare(t)`` fills inputs that derive from others (a forward's
    #: output and log-sum-exp for a backward) once all are drawn
    prepare: Callable | None = None

    def tol_of(self, name: str) -> float:
        if isinstance(self.tol, dict):
            return self.tol.get(name, self.tol.get("*", 2.0 ** -7))
        return self.tol

    def __post_init__(self):
        by_name = {}
        for op in self.operands:
            if op.name in by_name:
                raise ValueError(f"example {self.label}: operand {op.name} "
                                 "declared twice")
            by_name[op.name] = op
        self.by_name = by_name
        for k in self.kernels:
            for m in list(k.writes or []) + list(k.reads):
                if m.operand not in by_name:
                    raise ValueError(f"example {self.label}: kernel "
                                     f"{k.kernel} maps unknown operand "
                                     f"{m.operand}")
                m.bind(by_name[m.operand])

    def operand(self, name: str) -> Operand:
        return self.by_name[name]

    @property
    def outputs(self) -> list:
        return [op for op in self.operands if op.role != "in"]


@dataclasses.dataclass
class ExtractionNote:
    """Why a file or an example could not be modelled."""
    file: str
    label: str
    message: str


# -- tile maps of the common shapes -----------------------------------------

def rows_map(operand: str, rows: int, width: int, per_block: int = 1,
             axis: int = 0) -> TileMap:
    """Block ``b`` (along grid ``axis``) covers rows ``[b * per_block,
    (b + 1) * per_block)`` of the operand seen as ``[rows, width]``."""
    return TileMap(operand, (per_block, width),
                   lambda *b: (b[axis], 0), view=(rows, width))


def whole_map(operand: str, shape) -> TileMap:
    """Every block reaches the whole operand (a weight vector, a scalar)."""
    shape = tuple(shape)
    return TileMap(operand, shape, lambda *b: (0,) * len(shape))


def stride_map(operand: str, numel: int, chunk: int, grid: int) -> TileMap:
    """A grid-stride loop over the flat operand: block ``b`` covers chunks
    ``b, b + grid, b + 2 grid, ...`` of ``chunk`` elements."""
    n_chunks = max(1, -(-numel // chunk))
    return TileMap(operand, (chunk,),
                   lambda bx, by, bz: [(c,) for c in
                                       range(bx, n_chunks, grid)],
                   view=(numel,))


# -- extraction --------------------------------------------------------------

def load_kernel_module(path: str):
    """Import a kernel module by file path, through its package name when
    it lies under ``paddle_tpu_torch`` (so relative imports work)."""
    path = os.path.abspath(path)
    parts = path.replace("\\", "/").split("/")
    if "paddle_tpu_torch" in parts:
        modname = ".".join(parts[parts.index("paddle_tpu_torch"):])
        modname = modname[:-3] if modname.endswith(".py") else modname
        modname = modname[:-len(".__init__")] \
            if modname.endswith(".__init__") else modname
        return importlib.import_module(modname)
    spec = importlib.util.spec_from_file_location(
        os.path.splitext(os.path.basename(path))[0], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _def_line(mod, name: str) -> int:
    import inspect
    try:
        return inspect.getsourcelines(getattr(mod, name))[1]
    except (OSError, TypeError, AttributeError):
        return 0


def extract_module(path: str):
    """(examples, notes) of one kernel module file.

    A module without ``ck_examples()`` gives no example and one note; a
    ``ck_examples()`` that raises gives a note naming it. Each example
    (and its tail) without a line of its own is anchored at the module's
    ``ck_examples`` line."""
    notes: list = []
    try:
        mod = load_kernel_module(path)
    except Exception as e:                       # noqa: BLE001 — reported
        notes.append(ExtractionNote(
            path, "", f"module import failed: {type(e).__name__}: {e}"))
        return [], notes
    examples = getattr(mod, "ck_examples", None)
    if examples is None:
        notes.append(ExtractionNote(
            path, "", "no ck_examples(): the module's C entries are not "
            "modelled (source rules only)"))
        return [], notes
    try:
        entries = list(examples())
    except Exception as e:                       # noqa: BLE001 — reported
        notes.append(ExtractionNote(
            path, "ck_examples",
            f"ck_examples() raised: {type(e).__name__}: {e}"))
        return [], notes
    line = _def_line(mod, "ck_examples")
    for ex in entries:
        for e in (ex, ex.tail):
            if isinstance(e, Example):
                e.file, e.line = path, e.line or line
    return entries, notes
