"""Resource sheets: what the compiler gave each kernel, and what a launch
of it holds and costs on the card.

The resource plane reads the log that ``nvcc --resource-usage`` (ptxas
``-v``) writes for every library (``_build.usage_path``): each entry
function's registers, static shared memory, stack frame, spill stores and
loads, and barriers, under its mangled name. :func:`parse_resource_usage`
demangles the names with ``c++filt`` (binutils) and keys them by the base
name and template arguments, as a declaration and the profiler name them
(:func:`canonical_name`). A :class:`ResourceSheet` joins one declared
launch with its kernel's usage: resident blocks a multiprocessor holds by
the preset's limits (:func:`occupancy`), whether the launch fits, and the
example's operations, bytes and least time (``predicted_ms``, the
roofline of ``cost_model.roofline_ms``). The counterpart of
``paddle_tpu/analysis/kernels/resources.py``, whose figures are traced
from the Pallas body; here they come from the compiler.
"""

from __future__ import annotations

import dataclasses
import re
import shutil
import subprocess

from ...cost_model import device_preset, roofline_ms
from .model import Example, KernelLaunch

__all__ = ["KernelUsage", "ResourceSheet", "parse_resource_usage",
           "canonical_name", "demangle", "occupancy", "resource_sheet",
           "static_sheet", "cuobjdump_registers", "parse_cuobjdump"]

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_BARRIERS = re.compile(r"used (\d+) barriers")
_SMEM = re.compile(r"(\d+) bytes smem")


@dataclasses.dataclass
class KernelUsage:
    """One entry function as ptxas reports it."""
    mangled: str
    demangled: str = ""
    name: str = ""               # canonical: base name<template arguments>
    registers: int = 0
    static_smem: int = 0
    stack: int = 0
    spill_stores: int = 0
    spill_loads: int = 0
    barriers: int = 0


def demangle(names) -> list:
    """Demangled forms of ``names`` through one ``c++filt`` call; raises
    when ``c++filt`` is missing."""
    names = list(names)
    if not names:
        return []
    tool = shutil.which("c++filt")
    if tool is None:
        raise RuntimeError("c++filt (binutils) is needed to read ptxas's "
                           "mangled kernel names")
    out = subprocess.run([tool], input="\n".join(names) + "\n",
                         capture_output=True, text=True, check=True).stdout
    lines = out.splitlines()
    if len(lines) != len(names):
        raise RuntimeError(f"c++filt gave {len(lines)} names for "
                           f"{len(names)}")
    return lines


def canonical_name(name: str) -> str:
    """``base<targs>`` of a kernel name as a declaration, ptxas (after
    ``c++filt``) or the profiler writes it: no return type, namespace,
    parameter list or spaces. ``void (anonymous namespace)::k<2>(int)``
    and ``k<2>`` both give ``k<2>``."""
    s = name.strip()
    s = s.replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    # cut the parameter list: the first '(' outside template brackets
    depth = 0
    for i, ch in enumerate(s):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            s = s[:i]
            break
    # drop namespaces: the last '::' outside template brackets
    depth, cut = 0, 0
    for i, ch in enumerate(s):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == ":" and depth == 0 and s[i:i + 2] == "::":
            cut = i + 2
    s = s[cut:]
    return re.sub(r"\s+", "", s)


def parse_resource_usage(text: str) -> list:
    """Every entry function of one ptxas ``-v`` log, as
    :class:`KernelUsage` (demangled and keyed by :func:`canonical_name`)."""
    usages: dict = {}
    current = props_for = None
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            current = usages.setdefault(m.group(1), KernelUsage(m.group(1)))
            continue
        m = _PROPS.search(line)
        if m:
            props_for = m.group(1)
            continue
        m = _FRAME.search(line)
        if m and props_for in usages:
            u = usages[props_for]
            u.stack, u.spill_stores, u.spill_loads = map(int, m.groups())
            continue
        m = _USED.search(line)
        if m and current is not None:
            current.registers = int(m.group(1))
            b = _BARRIERS.search(line)
            current.barriers = int(b.group(1)) if b else 0
            s = _SMEM.search(line)
            current.static_smem = int(s.group(1)) if s else 0
    out = list(usages.values())
    for u, d in zip(out, demangle(u.mangled for u in out)):
        u.demangled = d
        u.name = canonical_name(d)
    return out


_CUOBJ_FN = re.compile(r"Function (\S+):")
_CUOBJ_REG = re.compile(r"REG:(\d+)")


def cuobjdump_registers(so_path) -> dict | None:
    """``{mangled name: registers}`` from ``cuobjdump
    --dump-resource-usage`` of a built library, or None where the toolkit
    has no cuobjdump (the cross-check is optional)."""
    tool = shutil.which("cuobjdump")
    if tool is None:
        import os
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "cuobjdump")
        tool = cand if os.path.isfile(cand) else None
    if tool is None:
        return None
    return parse_cuobjdump(subprocess.run(
        [tool, "--dump-resource-usage", str(so_path)], capture_output=True,
        text=True, check=True).stdout)


def parse_cuobjdump(text: str) -> dict:
    """``{mangled name: registers}`` of ``cuobjdump --dump-resource-usage``
    output."""
    regs, name = {}, None
    for line in text.splitlines():
        m = _CUOBJ_FN.search(line)
        if m:
            name = m.group(1)
            continue
        m = _CUOBJ_REG.search(line)
        if m and name is not None:
            regs[name] = int(m.group(1))
            name = None
    return regs


def occupancy(threads: int, registers: int | None, smem: int,
              preset: dict) -> int:
    """Blocks of ``threads`` threads, ``registers`` registers a thread and
    ``smem`` bytes of shared memory (static + dynamic) that one
    multiprocessor holds at once, by the preset's limits (the CUDA
    occupancy calculator's rules for compute capability 9.0; registers
    unknown count as none)."""
    if threads <= 0 or threads > preset["threads_per_block"]:
        return 0
    warps = -(-threads // 32)
    limits = [preset["blocks_per_sm"],
              preset["threads_per_sm"] // (warps * 32)]
    if registers:
        g = preset["reg_granularity"]
        per_warp = -(-registers * 32 // g) * g
        limits.append(preset["regs_per_sm"] // (per_warp * warps))
    g = preset["smem_granularity"]
    per_block = -(-(smem + preset["smem_reserved_per_block"]) // g) * g
    limits.append(preset["smem_per_sm"] // per_block)
    return max(0, min(limits))


@dataclasses.dataclass
class ResourceSheet:
    """One declared launch (or, with ``label`` empty, one compiled kernel
    that no example launches) and what it holds and costs. ``flops``,
    ``nbytes`` and ``predicted_ms`` are the whole example's: one call of
    its C entry, which may launch several kernels."""
    kernel: str
    label: str
    library: str
    file: str = ""
    line: int = 0
    grid: tuple = ()
    block: tuple = ()
    threads: int = 0
    registers: int | None = None
    static_smem: int | None = None
    dynamic_smem: int = 0
    stack: int | None = None
    spill_stores: int | None = None
    spill_loads: int | None = None
    barriers: int | None = None
    occupancy: int | None = None      # resident blocks a multiprocessor
    waves: float | None = None        # blocks / (occupancy x SMs)
    fits: bool | None = None
    cooperative: bool = False
    flops: float = 0.0
    nbytes: float = 0.0
    unit: str = "f32"
    arithmetic_intensity: float = 0.0
    predicted_ms: float = 0.0
    notes: list = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["grid"], d["block"] = list(self.grid), list(self.block)
        return d

    def line_text(self) -> str:
        def v(x):
            return "?" if x is None else x
        smem = (f"{v(self.static_smem)}+{self.dynamic_smem}"
                if self.label else f"{v(self.static_smem)}")
        return (f"{self.kernel} [{self.label or 'not launched'}] "
                f"grid={list(self.grid)} block={list(self.block)} "
                f"regs={v(self.registers)} smem={smem}B "
                f"spills={v(self.spill_stores)}/{v(self.spill_loads)}B "
                f"occupancy={v(self.occupancy)} "
                f"predicted_ms={self.predicted_ms:.6g}")


def resource_sheet(ex: Example, k: KernelLaunch,
                   usage: KernelUsage | None) -> ResourceSheet:
    """The sheet of launch ``k`` of example ``ex``; ``usage`` is its
    kernel's ptxas entry, or ``None`` where the resource plane did not run
    (registers, static shared memory and spills then stay unknown)."""
    preset = device_preset()
    static = usage.static_smem if usage else 0
    occ = occupancy(k.threads, usage.registers if usage else None,
                    static + k.smem, preset)
    fits = (static + k.smem <= preset["smem_per_block_optin"]
            and k.threads <= preset["threads_per_block"] and occ > 0
            and (not k.cooperative or k.blocks <= occ * preset["sms"]))
    sheet = ResourceSheet(
        kernel=k.kernel, label=ex.label, library=ex.library, file=ex.file,
        line=ex.line, grid=k.grid, block=k.block, threads=k.threads,
        dynamic_smem=k.smem, occupancy=occ,
        waves=(k.blocks / (occ * preset["sms"])) if occ else None,
        fits=fits, cooperative=k.cooperative, flops=float(ex.flops),
        nbytes=float(ex.nbytes), unit=ex.unit,
        arithmetic_intensity=round(ex.flops / max(ex.nbytes, 1), 3),
        predicted_ms=roofline_ms(ex.flops, ex.nbytes, ex.unit))
    if usage is not None:
        sheet.registers, sheet.static_smem = usage.registers, static
        sheet.stack, sheet.barriers = usage.stack, usage.barriers
        sheet.spill_stores = usage.spill_stores
        sheet.spill_loads = usage.spill_loads
    else:
        sheet.notes.append("resource plane not run: registers, static "
                           "shared memory and spills unknown")
    return sheet


def static_sheet(usage: KernelUsage, library: str,
                 source: str = "") -> ResourceSheet:
    """The sheet of a compiled kernel that no example launches: what the
    compiler gave it, no launch (anchored at its CUDA ``source``)."""
    return ResourceSheet(
        kernel=usage.name, label="", library=library, file=source,
        registers=usage.registers, static_smem=usage.static_smem,
        stack=usage.stack, spill_stores=usage.spill_stores,
        spill_loads=usage.spill_loads, barriers=usage.barriers,
        notes=["compiled, not declared by any example"])
