"""The card plane: what makes the declared launch models trustworthy.

For every example, at its declared shape and at its tail shape:

(a) **profiled launch** — ``launch`` runs once under ``torch.profiler``
    and every kernel event of the trace (its demangled name, ``grid``,
    ``block``, ``shared memory`` = static + dynamic and ``registers per
    thread``) must equal the declared :class:`~.model.KernelLaunch` joined
    with its resource sheet, in order (else CK209 at ERROR severity: the
    model is not what runs);
(b) **guard-band launch** — every operand is placed at a 256-byte-aligned
    offset inside a larger buffer, between two guard bands of at least one
    tile and 64 KiB that hold a poison pattern (a NaN payload arithmetic
    never makes for float dtypes, ``0xA5`` bytes otherwise); pure outputs
    are pre-filled with another pattern, the sentinel. After the launch
    every band must be unchanged byte for byte and every input unchanged
    (else CK203, a write out of bounds), no sentinel may remain in an
    output whose writes are declared (else CK202), no NaN may appear
    where the plain version has none (else CK203, a read of the poison),
    and each output must match the plain version within the example's
    tolerance (else CK203). In-place operands are guarded but keep their
    data. A launch the card refuses is CK200.

The compute-sanitizer tools do not run where the port is measured, so
this plane is the port's own code. It needs a CUDA device.
"""

from __future__ import annotations

import json
import math
import os
import tempfile

from ..diagnostics import Finding
from .model import Example
from .resources import canonical_name
from .rules import RULES

__all__ = ["ALIGN", "MIN_BAND", "profile_example", "guard_example",
           "run_card_plane"]

ALIGN = 256
MIN_BAND = 64 * 1024

# poison and sentinel bit patterns by element size: NaN payloads for float
# dtypes (the card's arithmetic makes only 0x7fff / 0x7fffffff), repeated
# bytes otherwise
_FLOAT_PATTERNS = {2: (0x7FA5, 0x7F8B), 4: (0x7FA5A5A5, 0x7F8BAD00),
                   8: (0x7FF4A5A5A5A5A5A5, 0x7FF8BAD0BAD0BAD0)}
_BYTE_POISON, _BYTE_SENTINEL = 0xA5, 0x5A


def _find(rule_id, message, ex: Example, severity=None, symbol=""):
    r = RULES[rule_id]
    return Finding(rule_id=rule_id, severity=severity or r.severity,
                   message=f"[{ex.label}] {message}", file=ex.file,
                   line=ex.line, symbol=symbol, hint=r.hint)


def _round(n: int, a: int = ALIGN) -> int:
    return -(-n // a) * a


def _signed(value: int, size: int) -> int:
    return value - (1 << (8 * size)) if value >= 1 << (8 * size - 1) \
        else value


def bit_patterns(torch, dtype):
    """(integer dtype of ``dtype``'s size, poison, sentinel), the patterns
    as signed values of that integer dtype."""
    size = dtype.itemsize
    itype = {1: torch.int8, 2: torch.int16, 4: torch.int32,
             8: torch.int64}[size]
    if dtype.is_floating_point:
        poison, sentinel = _FLOAT_PATTERNS[size]
    else:
        poison = int.from_bytes(bytes([_BYTE_POISON]) * size, "little")
        sentinel = int.from_bytes(bytes([_BYTE_SENTINEL]) * size, "little")
    return itype, _signed(poison, size), _signed(sentinel, size)


def make_inputs(torch, ex: Example, device, seed: int = 0) -> dict:
    """The example's tensors on ``device``: declared data where an
    operand has it, normal draws for float operands, small integers for
    integer ones; outputs empty."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for op in ex.operands:
        if op.data is not None:
            t = op.data(gen, device)
            if tuple(t.shape) != op.shape or t.dtype != op.dtype:
                raise ValueError(f"[{ex.label}] data of {op.name} is "
                                 f"{t.dtype} {tuple(t.shape)}, declared "
                                 f"{op.dtype} {op.shape}")
        elif op.role == "out":
            t = torch.empty(op.shape, dtype=op.dtype, device=device)
        elif op.dtype.is_floating_point:
            t = torch.randn(op.shape, generator=gen, device=device
                            ).to(op.dtype)
        elif op.dtype in (torch.int8, torch.uint8):
            t = torch.randint(-127 if op.dtype == torch.int8 else 0, 127,
                              op.shape, generator=gen, device=device,
                              dtype=op.dtype)
        else:
            raise ValueError(f"[{ex.label}] integer operand {op.name} needs "
                             "declared data")
        out[op.name] = t.contiguous()
    if ex.prepare is not None:
        ex.prepare(out)
    return out


def _stream(torch, device) -> int:
    return torch.cuda.current_stream(device).cuda_stream \
        if device.type == "cuda" else 0


def _sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _band(ex: Example, op) -> int:
    tile = 0
    for k in ex.kernels:
        for m in list(k.writes or []) + list(k.reads):
            if m.operand == op.name:
                tile = max(tile, math.prod(m.block) * op.dtype.itemsize)
    return _round(max(MIN_BAND, tile))


def _kernel_events(trace_path: str) -> list:
    with open(trace_path, encoding="utf-8") as f:
        events = json.load(f).get("traceEvents", [])
    ks = [e for e in events if e.get("cat") == "kernel"]
    ks.sort(key=lambda e: e.get("ts", 0))
    return ks


_TRACE_TRIES = 3
_MIN_REGISTERS = 16


def _profiled_kernels(torch, ex: Example, t: dict, device) -> list:
    """The kernel events, in time order, of one launch under the
    profiler. A PyTorch kernel runs first in the session: without one,
    the session records no kernel at all for most launches made through
    a C entry (seen on the H100, torch 2.11); its events (``at::native``)
    are left out of the result."""
    from torch.profiler import ProfilerActivity, profile
    stream = _stream(torch, device)
    _sync(torch, device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device=device).add_(1)
        ex.launch(t, stream)
        _sync(torch, device)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="ck_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return [e for e in _kernel_events(path)
                if "at::native" not in e.get("name", "")]
    finally:
        os.unlink(path)


def profile_example(torch, ex: Example, usage_by_name: dict, device,
                    findings: list) -> list:
    """(a): the kernel events of one launch under the profiler, each held
    against its declaration. Returns the events' names, grids, blocks and
    shared memory as recorded."""
    t = make_inputs(torch, ex, device)
    # a profiler session now and then loses kernel records: a launch count
    # other than the declared one is tried again, and reported only when
    # every try gives it
    for _ in range(_TRACE_TRIES):
        try:
            events = _profiled_kernels(torch, ex, t, device)
        except RuntimeError as e:
            findings.append(_find(
                "CK200", f"the card refused the launch: {e}", ex))
            return []
        if len(events) == len(ex.kernels):
            break
    seen = [{"name": canonical_name(e["name"]),
             "grid": list(e["args"].get("grid", [])),
             "block": list(e["args"].get("block", [])),
             "smem": e["args"].get("shared memory"),
             "registers": e["args"].get("registers per thread")}
            for e in events]
    if len(seen) != len(ex.kernels):
        findings.append(_find(
            "CK209", f"the profiled launch made {len(seen)} kernel launches "
            f"({[s['name'] for s in seen]}), the declaration "
            f"{len(ex.kernels)}", ex, severity="error"))
        return seen
    for k, s in zip(ex.kernels, seen):
        u = usage_by_name.get(canonical_name(k.kernel))
        want = {"name": canonical_name(k.kernel), "grid": list(k.grid),
                "block": list(k.block),
                "smem": (u.static_smem if u else 0) + k.smem,
                # the card allocates at least 16 registers a thread
                "registers": max(u.registers, _MIN_REGISTERS) if u
                else s["registers"]}
        diff = {key: (want[key], s[key]) for key in want
                if want[key] != s[key]}
        if diff:
            findings.append(_find(
                "CK209", f"kernel '{k.kernel}': the profiled launch differs "
                f"from its declaration (declared, ran): {diff}", ex,
                severity="error", symbol=k.kernel))
    return seen


def guard_example(torch, ex: Example, device, findings: list) -> dict:
    """(b): one launch inside guard bands. Returns ``{"max_err", "tol"}``
    of the comparison with the plain version, or ``{"refused"}``. (The
    tests rehearse it on the CPU with a launch that writes the plain
    result; the analyzer runs it on the card only.)"""
    device = torch.device(device)
    src = make_inputs(torch, ex, device)
    expected = ex.plain({n: v.clone() for n, v in src.items()})
    bufs, t = {}, {}
    for op in ex.operands:
        band = _band(ex, op)
        body = _round(op.nbytes)
        buf = torch.empty(2 * band + body, dtype=torch.uint8, device=device)
        itype, poison, sentinel = bit_patterns(torch, op.dtype)
        buf.view(itype).fill_(poison)
        view = buf[band:band + op.nbytes].view(op.dtype).view(op.shape)
        if op.role == "out":
            view.view(itype).fill_(sentinel)
        else:
            view.copy_(src[op.name])
        bufs[op.name] = (buf, band, body)
        t[op.name] = view
    before = {n: (b[:band].clone(), b[band + body:].clone())
              for n, (b, band, body) in bufs.items()}
    try:
        ex.launch(t, _stream(torch, device))
        _sync(torch, device)
    except RuntimeError as e:
        findings.append(_find("CK200", f"the card refused the launch: {e}",
                              ex))
        return {"refused": str(e)}
    worst, worst_tol = 0.0, 0.0
    for op in ex.operands:
        buf, band, body = bufs[op.name]
        pre, post = before[op.name]
        for where, old, new in (("before", pre, buf[:band]),
                                ("after", post, buf[band + body:])):
            changed = int((old != new).sum())
            if changed:
                findings.append(_find(
                    "CK203", f"{changed} bytes of the guard band {where} "
                    f"{op.name} changed: a write out of bounds", ex))
        got = t[op.name]
        if op.role == "in":
            itype = bit_patterns(torch, op.dtype)[0]
            if not torch.equal(got.view(itype), src[op.name].view(itype)):
                findings.append(_find(
                    "CK203", f"input {op.name} was written", ex))
            continue
        if op.name not in expected:
            continue        # scratch: its bands are checked, not its values
        ref = expected[op.name]
        written = got
        if op.role == "out" and _declared_writes(ex, op.name):
            itype, _, sentinel = bit_patterns(torch, op.dtype)
            left = got.view(itype) == sentinel
            if ref.dtype == got.dtype and ref.shape == got.shape:
                # an integer output may hold the sentinel's value rightly
                left &= ref.view(itype) != sentinel
            n_left = int(left.sum())
            if n_left:
                findings.append(_find(
                    "CK202", f"{n_left} of {got.numel()} elements of "
                    f"{op.name} still hold the sentinel: never written", ex))
                if op.name not in ex.reduce and got.is_floating_point():
                    written = got.masked_fill(left, 0)
                    ref = ref.masked_fill(left, 0)
        if op.name in ex.reduce:
            written = ex.reduce[op.name](written)
        err, scale = _compare(torch, ex, op.name, written, ref, findings)
        tol = ex.tol_of(op.name) * scale
        worst, worst_tol = max(worst, err), max(worst_tol, tol)
        if err > tol:
            findings.append(_find(
                "CK203", f"{op.name} differs from the plain version by "
                f"{err:.6g} > {tol:.6g}", ex))
    return {"max_err": worst, "tol": worst_tol}


def _compare(torch, ex, name, got, ref, findings):
    """(max abs error, largest expected magnitude) of ``got`` against the
    plain version's ``ref``; a NaN in ``got`` where ``ref`` has none is a
    read of the poison (CK203)."""
    if not got.is_floating_point():
        if not got.numel():
            return 0.0, 0.0
        return (float((got.long() - ref.long()).abs().max()),
                float(ref.long().abs().max()))
    n_nan = int((torch.isnan(got) & ~torch.isnan(ref)).sum())
    if n_nan:
        findings.append(_find(
            "CK203", f"{n_nan} NaN in {name} where the plain version has "
            "none: a read of the guard poison", ex))
    both = torch.isfinite(got) & torch.isfinite(ref)
    diff = (got.float() - ref.float()).abs()[both]
    finite = ref.float().abs()[torch.isfinite(ref)]
    return (float(diff.max()) if diff.numel() else 0.0,
            float(finite.max()) if finite.numel() else 0.0)


def _declared_writes(ex: Example, name: str) -> bool:
    maps = [k.writes for k in ex.kernels]
    if any(w is None for w in maps):
        return False
    return any(m.operand == name for w in maps for m in w)


def run_card_plane(examples, usage_by_name: dict, report=None) -> list:
    """(a) and (b) over every example and its tail example; findings. Each
    run appends ``{label, file, shape, kernels, max_err, tol}`` to
    ``report`` when one is given."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("the card plane needs a CUDA device")
    device = torch.device("cuda")
    findings: list = []
    for ex in examples:
        for e, which in ((ex, "example"), (ex.tail, "tail")):
            if not isinstance(e, Example):
                continue
            seen = profile_example(torch, e, usage_by_name, device, findings)
            res = guard_example(torch, e, device, findings)
            if report is not None:
                report.append({"label": e.label, "which": which,
                               "file": os.path.basename(e.file),
                               "kernels": seen, **res})
            torch.cuda.empty_cache()
    return findings
