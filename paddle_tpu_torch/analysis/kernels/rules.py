"""CK200-CK209: the CUDA kernel safety rules of the port.

The ids mirror ``paddle_tpu/analysis/kernels/rules.py``'s PK200-PK209 one
for one, with the same severities. Three planes share the table:

* the DECLARATION plane (:func:`check_example`, runs on the CPU too): the
  launch limits of rule CK200 that the declaration alone decides, and
  coverage, overlap and bounds of every tile map, evaluated over the
  grid (CK201-CK203), a missing tail example (CK204), an undeclared write
  map (CK209);
* the RESOURCE plane (:func:`check_sheet`): CK200 with the compiler's
  registers and static shared memory, and spills (CK205);
* the SOURCE plane (:func:`check_source`, CK206): a C entry whose return
  code never reaches ``_build.check``, or a launch wrapped in an
  ``except`` that carries on, which the port's no-quiet-fallback rule
  forbids; and (:func:`check_module`, CK209) a module with C entries and
  no ``ck_examples()``, or a ``__global__`` function of its sources that
  no example launches.

The card plane (:mod:`.guard`) reports under CK200, CK202 and CK203 too.
Deliberate differences from the PK table: PK205's Mosaic miscompile has no
nvcc counterpart, so CK205 reports spills; PK207 and PK208 have no
launch-level counterpart and no CK rule.
"""

from __future__ import annotations

import ast
import itertools
import math
import os
import re
from dataclasses import dataclass

from ...cost_model import device_preset
from ..diagnostics import ERROR, INFO, WARNING, Finding
from .model import Example, KernelLaunch

__all__ = ["Rule", "RULES", "check_example", "check_sheet", "check_source",
           "check_module", "global_kernels", "c_libraries"]


@dataclass(frozen=True)
class Rule:
    id: str
    name: str
    severity: str
    summary: str
    hint: str


RULES = {r.id: r for r in [
    Rule("CK200", "resource-residency", ERROR,
         "a launch the card cannot run: static + dynamic shared memory "
         "over the per-block opt-in limit, registers x threads over the "
         "multiprocessor's register file, more than 1024 threads, or a "
         "cooperative grid larger than the blocks the card holds at once",
         "shrink the tile, the block or the grid (or the registers, with "
         "__launch_bounds__); keep dynamic shared memory within "
         "smem_per_block_bytes()"),
    Rule("CK201", "output-tile-overlap", ERROR,
         "two blocks write the same output tile and the operand is not "
         "declared as accumulated with atomics: the writes race",
         "give each block its own output tile, or declare the operand "
         "accumulate=True where the kernel adds into it atomically"),
    Rule("CK202", "output-coverage-gap", ERROR,
         "no block writes some tiles of an output (declared maps), or a "
         "sentinel survived the guard launch (card): those elements come "
         "back as whatever the buffer held",
         "cover every tile (grid = ceil(dim / tile) per dim) or shrink the "
         "output to what is written"),
    Rule("CK203", "out-of-bounds", ERROR,
         "a tile map reaches past an operand's extent (declared maps), or "
         "the guard launch changed a guard band or read its poison (card)",
         "bound the grid by the operand's tiles and mask the ragged edge "
         "in the kernel"),
    Rule("CK204", "no-tail-example", WARNING,
         "an example has no tail example: the kernel is never checked at "
         "a shape that is not a multiple of its tiles",
         "give the example a tail (a shape the kernel accepts with rows or "
         "columns past its last full tile), or the reason it accepts none"),
    Rule("CK205", "register-spills", WARNING,
         "ptxas spills registers to local memory in this kernel: each "
         "spilled value costs a round trip through the L1",
         "cut the registers a thread keeps live (smaller per-thread "
         "tiles, fewer unrolled vectors) or raise __launch_bounds__'s "
         "register budget"),
    Rule("CK206", "launch-discipline", ERROR,
         "a C entry's return code is not passed to _build.check, or a "
         "launch is wrapped in an except that carries on: a refused "
         "launch never runs and no later synchronise reports it",
         "pass every C entry's return code to _build.check(err, what) "
         "and let the RuntimeError propagate"),
    Rule("CK209", "kernel-hygiene", WARNING,
         "a kernel module with C entries and no ck_examples(), a "
         "__global__ function no example launches, or a launch whose "
         "writes are not declared: part of the port is not modelled",
         "declare the launch in the module's ck_examples()"),
]}


def _find(rule_id, message, file, line=0, symbol="", severity=None):
    r = RULES[rule_id]
    return Finding(rule_id=rule_id, severity=severity or r.severity,
                   message=message, file=file, line=line, symbol=symbol,
                   hint=r.hint)


# -- the declaration plane ---------------------------------------------------

def _declared_limits(ex: Example, k: KernelLaunch, preset, out):
    where = dict(file=ex.file, line=ex.line, symbol=k.kernel)
    if k.smem > preset["smem_per_block_optin"]:
        out.append(_find(
            "CK200", f"[{ex.label}] kernel '{k.kernel}' asks for {k.smem:,} "
            f"B of dynamic shared memory > the opt-in limit "
            f"{preset['smem_per_block_optin']:,} B", **where))
    if k.threads > preset["threads_per_block"]:
        out.append(_find(
            "CK200", f"[{ex.label}] kernel '{k.kernel}' has {k.threads} "
            f"threads a block > {preset['threads_per_block']}", **where))
    if max(k.grid[1:]) > 65535 or k.grid[0] > 2 ** 31 - 1:
        out.append(_find(
            "CK200", f"[{ex.label}] kernel '{k.kernel}': grid {k.grid} past "
            "the card's grid limits", **where))
    if math.prod(k.cluster) > 8 or any(g % c for g, c in zip(k.grid,
                                                               k.cluster)):
        out.append(_find(
            "CK200", f"[{ex.label}] kernel '{k.kernel}': cluster "
            f"{k.cluster} over grid {k.grid} (at most 8 blocks, dividing "
            "each grid dimension)", **where))


def _seq(m, k: KernelLaunch):
    """``[(block_id, [tiles])]`` over the whole grid."""
    return [(b, m.eval_index(b)) for b in k.block_ids()]


def _check_maps(ex: Example, k: KernelLaunch, out, written: dict):
    where = dict(file=ex.file, line=ex.line, symbol=k.kernel)
    maps = [(m, True) for m in (k.writes or [])] + [(m, False)
                                                   for m in k.reads]
    for m, is_write in maps:
        nb = m.nblocks
        if not k.enumerable:
            corners = [(0, 0, 0), tuple(g - 1 for g in k.grid)]
            for b in corners:
                bad = [t for t in m.eval_index(b)
                       if any(i < 0 or i >= n for i, n in zip(t, nb))]
                if bad:
                    out.append(_find(
                        "CK203", f"[{ex.label}] kernel '{k.kernel}': "
                        f"{m.operand} tile {bad[0]} at block {b} is past its "
                        f"{nb} tiles (grid corners only: {k.blocks} blocks "
                        "are too many to enumerate)", **where))
                    break
            if is_write:
                written.setdefault(m.operand, []).append(None)
            continue
        seq = _seq(m, k)
        oob = next(((b, t) for b, ts in seq for t in ts
                    if any(i < 0 or i >= n for i, n in zip(t, nb))), None)
        if oob is not None:
            out.append(_find(
                "CK203", f"[{ex.label}] kernel '{k.kernel}': {m.operand} "
                f"tile {oob[1]} at block {oob[0]} is past its {nb} tiles",
                **where))
            continue
        if not is_write:
            continue
        op = ex.operand(m.operand)
        if not op.accumulate:
            first = {}
            for b, ts in seq:
                for t in set(ts):
                    if t in first and first[t] != b:
                        out.append(_find(
                            "CK201", f"[{ex.label}] kernel '{k.kernel}': "
                            f"{m.operand} tile {t} written by blocks "
                            f"{first[t]} and {b} (a race)", **where))
                        break
                    first.setdefault(t, b)
                else:
                    continue
                break
        written.setdefault(m.operand, []).append(
            (m, {t for _, ts in seq for t in ts}))


def _check_coverage(ex: Example, written: dict, out):
    import numpy as np
    for op in ex.operands:
        if op.role != "out" or op.name not in written:
            continue
        entries = written[op.name]
        if any(e is None for e in entries):
            continue           # a grid past the enumeration cap
        if len(entries) == 1:
            m, tiles = entries[0]
            expected = set(itertools.product(*(range(n) for n in m.nblocks)))
            missing = sorted(expected - tiles)
            unit, total = "tiles", len(expected)
        else:
            # several maps write it: cover its elements
            mask = np.zeros(op.numel, bool)
            for m, tiles in entries:
                view = mask.reshape(m.array_shape)
                for t in tiles:
                    view[m.element_slices(t)] = True
            missing = np.flatnonzero(~mask).tolist()
            unit, total = "elements", op.numel
        if missing:
            out.append(_find(
                "CK202", f"[{ex.label}] no block writes {len(missing)}/"
                f"{total} {unit} of output {op.name} (e.g. {missing[:3]})",
                file=ex.file, line=ex.line))


def check_example(ex: Example, findings=None) -> list:
    """The declaration plane over one example (and its tail example)."""
    out = findings if findings is not None else []
    preset = device_preset()
    for e in (ex, ex.tail if isinstance(ex.tail, Example) else None):
        if e is None:
            continue
        written: dict = {}
        for k in e.kernels:
            _declared_limits(e, k, preset, out)
            if k.writes is None:
                out.append(_find(
                    "CK209", f"[{e.label}] kernel '{k.kernel}': write map "
                    "not declared (its writes depend on the data): guard "
                    "plane only", file=e.file, line=e.line, symbol=k.kernel,
                    severity=INFO))
            _check_maps(e, k, out, written)
        _check_coverage(e, written, out)
    if ex.tail is None:
        out.append(_find(
            "CK204", f"[{ex.label}] no tail example: the kernels are never "
            "checked past their last full tile", file=ex.file, line=ex.line))
    return out


# -- the resource plane -------------------------------------------------------

def check_sheet(sheet, findings=None) -> list:
    """CK200 and CK205 over one resource sheet of a declared launch."""
    out = findings if findings is not None else []
    preset = device_preset()
    where = dict(file=sheet.file, line=sheet.line, symbol=sheet.kernel)
    tag = f"[{sheet.label}] " if sheet.label else ""
    if sheet.label and sheet.static_smem is not None:
        total = sheet.static_smem + sheet.dynamic_smem
        if total > preset["smem_per_block_optin"] \
                and sheet.dynamic_smem <= preset["smem_per_block_optin"]:
            out.append(_find(
                "CK200", f"{tag}kernel '{sheet.kernel}': {total:,} B of "
                f"shared memory (static {sheet.static_smem:,} + dynamic "
                f"{sheet.dynamic_smem:,}) > {preset['smem_per_block_optin']:,}"
                " B", **where))
        if sheet.registers and sheet.registers * sheet.threads \
                > preset["regs_per_sm"]:
            out.append(_find(
                "CK200", f"{tag}kernel '{sheet.kernel}': {sheet.registers} "
                f"registers x {sheet.threads} threads > "
                f"{preset['regs_per_sm']:,}", **where))
    if sheet.label and sheet.cooperative and sheet.occupancy is not None:
        blocks = 1
        for g in sheet.grid:
            blocks *= g
        if blocks > sheet.occupancy * preset["sms"]:
            out.append(_find(
                "CK200", f"{tag}cooperative kernel '{sheet.kernel}': grid of "
                f"{blocks} blocks > {sheet.occupancy} a multiprocessor x "
                f"{preset['sms']}", **where))
    if sheet.spill_stores or sheet.spill_loads:
        # once a kernel and file, whichever examples launch it
        out.append(_find(
            "CK205", f"kernel '{sheet.kernel}' spills "
            f"{sheet.spill_stores} B stored / {sheet.spill_loads} B loaded "
            f"a thread ({sheet.registers} registers)", **where))
    return out


# -- the source plane ---------------------------------------------------------

def _call_name(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def _is_entry_getter(node) -> bool:
    """``_build.function(...)`` (or ``function(...)``)."""
    return isinstance(node, ast.Call) and _call_name(node) == "function"


def _is_launch(call: ast.Call, entries: set) -> bool:
    """A call of a C entry that hands it device pointers or a stream."""
    f = call.func
    if not ((isinstance(f, ast.Name) and f.id in entries)
            or _is_entry_getter(f)):
        return False
    for a in call.args:
        for n in ast.walk(a):
            if isinstance(n, ast.Call) and _call_name(n) in (
                    "data_ptr", "stream_of"):
                return True
            if isinstance(n, ast.Name) and n.id == "stream":
                return True
    return False


def _function_plane(fn, filename, out):
    parents = {}
    for node in ast.walk(fn):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    entries = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and _is_entry_getter(node.value):
            entries.update(t.id for t in node.targets
                           if isinstance(t, ast.Name))
    checked = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and _call_name(node) == "check":
            for a in node.args[:1]:
                if isinstance(a, ast.Name):
                    checked.add(a.id)
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Call) and _is_launch(node, entries)):
            continue
        parent = parents.get(node)
        ok = (isinstance(parent, ast.Call) and _call_name(parent) == "check"
              and parent.args and parent.args[0] is node)
        if not ok and isinstance(parent, ast.Assign):
            ok = any(isinstance(t, ast.Name) and t.id in checked
                     for t in parent.targets)
        if not ok:
            out.append(_find(
                "CK206", "C entry called without passing its return code "
                "to _build.check: a refused launch goes unreported",
                file=filename, line=node.lineno, symbol=fn.name))
        # an enclosing try whose handler carries on
        up = parents.get(node)
        while up is not None and up is not fn:
            if isinstance(up, ast.Try) and any(
                    not any(isinstance(n, ast.Raise) for n in ast.walk(h))
                    for h in up.handlers):
                out.append(_find(
                    "CK206", "launch wrapped in an except that carries on "
                    "(the port never falls back quietly)",
                    file=filename, line=up.lineno, symbol=fn.name))
                break
            up = parents.get(up)


def check_source(source: str, filename: str = "<string>") -> list:
    """The source plane (CK206) over one module's source."""
    out: list = []
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return out
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # innermost functions only own their calls: skip a function
            # whose body holds another function definition's calls twice
            _function_plane(node, filename, out)
    uniq, seen = [], set()
    for f in out:
        key = (f.rule_id, f.line, f.message)
        if key not in seen:
            seen.add(key)
            uniq.append(f)
    uniq.sort(key=lambda f: f.sort_key())
    return uniq


# -- module hygiene (CK209) ----------------------------------------------------

_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")


def c_libraries(source: str) -> list:
    """The libraries a module's ``_build.function("lib", ...)`` calls name."""
    out = []
    for m in re.finditer(r"_build\.function\(\s*\"(\w+)\"", source):
        if m.group(1) not in out:
            out.append(m.group(1))
    return out


def global_kernels(cu_source: str) -> list:
    """Names of the ``__global__`` functions a CUDA source defines."""
    return list(dict.fromkeys(_GLOBAL.findall(cu_source)))


def check_module(path: str, source: str, examples, csrc_dir,
                 findings=None) -> list:
    """CK209 over one module: C entries without ``ck_examples()`` (info),
    and each ``__global__`` function of the module's libraries that no
    example (or tail example) launches (warning)."""
    out = findings if findings is not None else []
    libs = c_libraries(source)
    if not libs:
        return out
    if examples is None:
        out.append(_find(
            "CK209", "no ck_examples(): the module's C entries "
            f"({', '.join(libs)}) are not modelled", file=path,
            severity=INFO))
        return out
    launched = set()
    for ex in examples:
        for e in (ex, ex.tail):
            if isinstance(e, Example):
                launched.update(k.kernel.split("<")[0] for k in e.kernels)
    for lib in libs:
        cu = os.path.join(csrc_dir, f"{lib}.cu")
        try:
            with open(cu, encoding="utf-8") as f:
                names = global_kernels(f.read())
        except OSError:
            continue
        for name in names:
            if name not in launched:
                out.append(_find(
                    "CK209", f"__global__ {name} of {lib}.cu: not launched "
                    "by any example", file=path, symbol=name))
    return out
