"""paddle_tpu_torch.analysis.kernels — the CUDA kernel analysis tier.

The counterpart of ``paddle_tpu/analysis/kernels`` (the Pallas tier,
PK200-PK209) for the port's hand-written kernels, rules CK200-CK209
(:mod:`.rules`). The Pallas tier gets its launch model by tracing the real
``pallas_call``; a CUDA launch has no trace, so each kernel module of the
port declares its launches in ``ck_examples()`` (:mod:`.model`) and the
card proves the declarations. Four planes:

* **declaration** (CPU and card): launch limits, and coverage, overlap
  and bounds of every tile map evaluated over the grid;
* **resource** (card): each library's ptxas log (``nvcc
  --resource-usage``, kept beside it by ``_build``) parsed into
  registers, shared memory, stack and spills, joined with the declared
  launches into resource sheets (:mod:`.resources`) with occupancy and
  the roofline's ``predicted_ms``;
* **card** (:mod:`.guard`): each example and its tail example launched
  under the profiler (what ran must equal what was declared) and inside
  guard bands (no write outside an operand, no unwritten output, no read
  of the poison, the plain version's result);
* **source** (CPU and card): every C entry's return code reaches
  ``_build.check`` and no launch sits in an ``except`` that carries on
  (CK206); every module with C entries has examples, and every
  ``__global__`` function is launched by one (CK209).

The tier runs on the card unless the caller asks for the CPU
(``device="cpu"``, ``--device cpu``), where only the declaration and
source planes run and one finding says so. By default it needs ``nvcc``
and a CUDA device, and raises without them.

Entry points: ``python -m paddle_tpu_torch.analysis.kernels <paths>``
(flags and exit codes of ``paddle_tpu_torch.analysis.cli``, plus
``--device``; waivers in ``allowlist.txt`` beside this file) and
``python -m paddle_tpu_torch.analysis.kernels.demo`` (the planted faults).
"""

from __future__ import annotations

import os

from ..diagnostics import ERROR, INFO, Finding  # noqa: F401
from ..engine import _iter_py_files, has_errors
from .model import (GRID_ENUM_CAP, Example, ExtractionNote,  # noqa: F401
                    KernelLaunch, Operand, TileMap, extract_module)
from .resources import (ResourceSheet, canonical_name,  # noqa: F401
                        cuobjdump_registers, parse_resource_usage,
                        resource_sheet, static_sheet)
from .rules import (RULES, Rule, c_libraries, check_example,  # noqa: F401
                    check_module, check_sheet, check_source)

__all__ = ["RULES", "Rule", "check_example", "check_sheet", "check_source",
           "check_module", "Example", "KernelLaunch", "Operand", "TileMap",
           "ResourceSheet", "resource_sheet", "parse_resource_usage",
           "extract_module", "analyze_paths", "collect", "kernel_cost",
           "has_errors", "ALLOWLIST_NAME", "GRID_ENUM_CAP", "resolve_device"]

ALLOWLIST_NAME = os.path.join("paddle_tpu_torch", "analysis", "kernels",
                              "allowlist.txt")
_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")


def resolve_device(device=None) -> str:
    """``"cpu"`` or ``"cuda"``: ``None`` means the card, which must be
    there with ``nvcc`` to build on."""
    dev = "cuda" if device is None else str(device)
    if dev.startswith("cuda"):
        import torch

        from ...ops.kernels import _build
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the kernel analyzer runs on a CUDA device and none is "
                "available; pass device='cpu' (--device cpu) for the "
                "declaration and source planes alone")
        _build._nvcc()                   # raises without nvcc
        return "cuda"
    if dev != "cpu":
        raise ValueError(f"unknown device {device!r} (cpu or cuda)")
    return "cpu"


def _usages(libraries, findings=None) -> dict:
    """``{library: {canonical name: KernelUsage}}`` from the kept logs;
    where cuobjdump exists, each function's registers are held against
    the built library's (a difference is a CK209 error in ``findings``)."""
    from ...ops.kernels import _build
    out = {}
    for lib in libraries:
        usages = parse_resource_usage(_build.resource_usage(lib))
        out[lib] = {u.name: u for u in usages}
        built = cuobjdump_registers(_build.lib_path(lib)) \
            if findings is not None else None
        for u in usages if built is not None else ():
            if built.get(u.mangled) != u.registers:
                findings.append(Finding(
                    rule_id="CK209", severity=ERROR,
                    message=f"{u.name}: ptxas reports {u.registers} "
                    f"registers, cuobjdump {built.get(u.mangled)}",
                    file=os.path.join(_CSRC, f"{lib}.cu"), symbol=u.name,
                    hint=RULES["CK209"].hint))
    return out


def _join(ex: Example, k: KernelLaunch, usages: dict):
    by_name = usages.get(ex.library)
    if by_name is None:
        return None
    u = by_name.get(canonical_name(k.kernel))
    if u is None:
        raise LookupError(
            f"[{ex.label}] kernel '{k.kernel}' of {ex.library}.cu is not in "
            f"its ptxas log (compiled: {sorted(by_name)})")
    return u


def collect(paths, device=None, report=None):
    """(findings, sheets) over every ``.py`` file under ``paths``.

    The source plane runs on every file; kernel modules (those that call
    ``_build.function`` or define ``ck_examples()``) are modelled through
    their examples, checked, costed and, on the card, proven. ``report``,
    a list, receives one record per card-plane launch."""
    dev = resolve_device(device)
    findings: list = []
    pending: list = []
    for path in _iter_py_files(paths):
        try:
            with open(path, encoding="utf-8") as f:
                src = f.read()
        except OSError:
            continue
        findings.extend(check_source(src, path))
        libs = c_libraries(src)
        if not libs and "def ck_examples" not in src:
            continue
        examples, notes = extract_module(path)
        for note in notes:
            if "no ck_examples()" in note.message:
                continue                  # check_module reports it
            findings.append(Finding(
                rule_id="CK209", severity=INFO,
                message=(f"[{note.label}] " if note.label else "")
                + note.message, file=note.file,
                hint=RULES["CK209"].hint))
        has = not any("no ck_examples()" in n.message for n in notes)
        check_module(path, src, examples if has else None, _CSRC, findings)
        for ex in examples:
            check_example(ex, findings)
            pending.append(ex)
    sheets: list = []
    if dev == "cpu":
        if pending:
            findings.append(Finding(
                rule_id="CK209", severity=INFO,
                message="device cpu: the resource and card planes did not "
                "run (registers, shared memory, spills, the profiled "
                "launches and the guard bands are unchecked)",
                file=pending[0].file, hint="run on the card for all planes"))
        for ex in pending:
            for e in (ex, ex.tail):
                if isinstance(e, Example):
                    sheets.extend(resource_sheet(e, k, None)
                                  for k in e.kernels)
    else:
        from .guard import run_card_plane
        usages = _usages(dict.fromkeys(ex.library for ex in pending),
                         findings)
        joined = set()
        for ex in pending:
            for e in (ex, ex.tail):
                if not isinstance(e, Example):
                    continue
                for k in e.kernels:
                    u = _join(e, k, usages)
                    joined.add((e.library, u.name))
                    s = resource_sheet(e, k, u)
                    check_sheet(s, findings)
                    sheets.append(s)
        for lib, by_name in usages.items():
            for name, u in by_name.items():
                if (lib, name) not in joined:
                    s = static_sheet(u, lib, os.path.join(_CSRC,
                                                          f"{lib}.cu"))
                    check_sheet(s, findings)
                    sheets.append(s)
        flat = {name: u for by_name in usages.values()
                for name, u in by_name.items()}
        findings.extend(run_card_plane(pending, flat, report=report))
    uniq, seen = [], set()
    for f in findings:
        key = (f.rule_id, f.file, f.line, f.severity, f.message)
        if key not in seen:
            seen.add(key)
            uniq.append(f)
    uniq.sort(key=lambda f: f.sort_key())
    return uniq, sheets


def analyze_paths(paths, device=None) -> list:
    """Findings only (the CLI surface; sheets ride :func:`collect` and
    :func:`kernel_cost`)."""
    return collect(paths, device=device)[0]


def kernel_cost(module_or_path, device=None) -> dict:
    """Resource sheets of one kernel module (the ``cost_model.kernel_cost``
    implementation): ``{module, device, smem_budget, kernels: [sheet...],
    notes: [...]}`` — the keys of the JAX tier's, with ``device`` for
    ``chip`` and the shared-memory budget for the VMEM one. On the card
    each sheet carries the compiler's registers, shared memory and spills;
    with ``device="cpu"`` those stay unknown."""
    import importlib

    from ...cost_model import smem_per_block_bytes
    if hasattr(module_or_path, "__file__"):
        path = module_or_path.__file__
    elif os.path.sep in str(module_or_path) \
            or str(module_or_path).endswith(".py"):
        path = str(module_or_path)
    else:
        path = importlib.import_module(str(module_or_path)).__file__
    dev = resolve_device(device)
    examples, notes = extract_module(path)
    usages = _usages(dict.fromkeys(ex.library for ex in examples)) \
        if dev == "cuda" else {}
    kernels = []
    for ex in examples:
        for k in ex.kernels:
            s = resource_sheet(ex, k, _join(ex, k, usages))
            kernels.append(_join_measured(s.to_dict()))
    return {"module": os.path.basename(path), "device": "h100",
            "smem_budget": smem_per_block_bytes(), "kernels": kernels,
            "notes": [f"[{n.label}] {n.message}" if n.label else n.message
                      for n in notes]}


#: libraries whose kernels the tuner measures, by the tuner's kernel key
_TUNED = {"decode_layer": "block_decode_layer"}


def _join_measured(sheet: dict) -> dict:
    """Prefer a tuning-cache measurement over the roofline: every sheet
    gains ``cost_source``; the decode layer's, when the port's tuner has
    measured it on this card, ``measured_ms``, ``tuned_block`` and
    ``predicted_vs_measured``."""
    from ...ops.kernels import autotune
    sheet["cost_source"] = "roofline"
    key = _TUNED.get(sheet.get("library"))
    entry = autotune.lookup_measured(key) if key else None
    if entry and entry.get("ms"):
        sheet["measured_ms"] = float(entry["ms"])
        sheet["tuned_block"] = entry.get("block_i")
        sheet["cost_source"] = "measured"
        if sheet["measured_ms"] > 0:
            sheet["predicted_vs_measured"] = round(
                sheet["predicted_ms"] / sheet["measured_ms"], 4)
    return sheet
