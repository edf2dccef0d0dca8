"""The command-line contract of the port's analysis tiers (counterpart of
``paddle_tpu/analysis/cli.py:29-192``).

``--format text|json``, ``--select``, ``--min-severity``, ``--list-rules``,
allowlist waivers discovered by walking up from the analyzed paths
(``--allowlist``, ``--no-allowlist``), and exit 1 exactly when an
unwaived error-severity finding remains; 2 on a usage error (argparse).
A tier registers flags of its own (the kernel tier's ``--device``)
through ``add_arguments``, and its ``analyze(paths, args)`` sees them.
"""

from __future__ import annotations

import argparse
import json
import os

from .diagnostics import ERROR, SEVERITIES, format_text, severity_rank

__all__ = [
    "build_parser", "rule_table", "filter_findings",
    "load_allowlist", "discover_allowlist", "apply_allowlist",
    "run_lint_cli",
]


def rule_table(rules) -> str:
    """The ``--list-rules`` text: one aligned row per rule (accepts the
    tier's ``{id: Rule}`` dict or any iterable of rules)."""
    vals = rules.values() if hasattr(rules, "values") else rules
    return "\n".join(f"{r.id}  {r.severity:7s}  {r.name}: {r.summary}"
                     for r in sorted(vals, key=lambda r: r.id))


def build_parser(prog: str, description: str, *,
                 positional_help: str = ".py files or directories to lint",
                 select_example: str = "TS001,TS005",
                 allowlist_name: str | None = None
                 ) -> argparse.ArgumentParser:
    """ArgumentParser with the house-style flags; tiers may add more."""
    ap = argparse.ArgumentParser(prog=prog, description=description)
    ap.add_argument("paths", nargs="*", help=positional_help)
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--select", default=None,
                    help="comma-separated rule ids to report "
                         f"(e.g. {select_example}); default: all")
    ap.add_argument("--min-severity", choices=SEVERITIES, default="info",
                    help="drop findings below this severity")
    if allowlist_name:
        ap.add_argument("--allowlist", default=None,
                        help=f"waiver file (default: {allowlist_name} "
                             "discovered above the analyzed paths)")
        ap.add_argument("--no-allowlist", action="store_true",
                        help="report waived findings too (fixture tests)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    return ap


def filter_findings(findings, select=None, min_severity="info"):
    """Apply ``--select`` / ``--min-severity`` exactly as every tier
    always has: rule-id whitelist, then severity floor."""
    if select:
        keep = {s.strip().upper() for s in select.split(",")}
        findings = [f for f in findings if f.rule_id in keep]
    max_rank = severity_rank(min_severity)
    return [f for f in findings if severity_rank(f.severity) <= max_rank]


# ---------------------------------------------------------------------------
# allowlists: one "<file-suffix> <RULE>" per line, '#' comments carry the
# mandatory justification
# ---------------------------------------------------------------------------

def load_allowlist(path) -> set:
    """``{(file_suffix, rule_id), ...}`` from one ``<path> <rule>``-per-
    line file; ``#`` comments carry the mandatory justification."""
    out = set()
    try:
        with open(path) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                parts = line.split()
                if len(parts) >= 2:
                    out.add((parts[0].replace("\\", "/"),
                             parts[1].upper()))
    except OSError:
        pass
    return out


def discover_allowlist(paths, name) -> str | None:
    """Walk up from each analyzed path looking for ``name`` (a path
    relative to some ancestor directory, e.g.
    ``paddle_tpu_torch/analysis/kernels/allowlist.txt``)."""
    for p in paths:
        d = os.path.abspath(p)
        if not os.path.isdir(d):
            d = os.path.dirname(d)
        while True:
            cand = os.path.join(d, name)
            if os.path.isfile(cand):
                return cand
            parent = os.path.dirname(d)
            if parent == d:
                break
            d = parent
    return None


def apply_allowlist(findings, entries) -> tuple:
    """(kept, waived) after dropping findings matching an allowlist
    entry (finding file endswith the entry path, rule ids equal)."""
    kept, waived = [], []
    for f in findings:
        file = f.file.replace("\\", "/")
        if any(file.endswith(suffix) and f.rule_id == rule
               for suffix, rule in entries):
            waived.append(f)
        else:
            kept.append(f)
    return kept, waived


# ---------------------------------------------------------------------------
# the end-to-end command line of the path-based tiers
# ---------------------------------------------------------------------------

def run_lint_cli(argv, *, prog, description, rules, analyze,
                 allowlist_name=None, select_example="TS001,TS005",
                 positional_help=".py files or directories to lint",
                 add_arguments=None, payload_extra=None,
                 text_extra=None) -> int:
    """Parse args, lint, waive, filter, print, and return the exit code.

    ``analyze(paths, args)`` produces the findings; ``add_arguments(ap)``
    lets a tier register extra flags; ``payload_extra(args)`` merges extra
    keys into the JSON payload and ``text_extra(args)`` prints extra
    text-mode lines — both run after ``analyze`` so they can expose
    whatever it cached (the kernel tier's resource sheets ride these).
    """
    ap = build_parser(prog, description,
                      positional_help=positional_help,
                      select_example=select_example,
                      allowlist_name=allowlist_name)
    if add_arguments:
        add_arguments(ap)
    args = ap.parse_args(argv)

    if args.list_rules:
        print(rule_table(rules))
        return 0
    if not args.paths:
        ap.error("no paths given (or use --list-rules)")

    findings = analyze(args.paths, args)
    waived: list = []
    if allowlist_name and not args.no_allowlist:
        path = args.allowlist or discover_allowlist(args.paths,
                                                    allowlist_name)
        if path:
            findings, waived = apply_allowlist(
                findings, load_allowlist(path))
    findings = filter_findings(findings, args.select, args.min_severity)

    if args.format == "json":
        payload = {
            "findings": [f.to_dict() for f in findings],
        }
        if allowlist_name:
            payload["waived"] = [f.to_dict() for f in waived]
        payload["counts"] = {s: sum(1 for f in findings if f.severity == s)
                             for s in SEVERITIES}
        if payload_extra:
            payload.update(payload_extra(args) or {})
        print(json.dumps(payload, indent=2))
    else:
        for f in findings:
            print(format_text(f))
        if text_extra:
            extra_lines = text_extra(args)
            if extra_lines:
                print(extra_lines)
        n_err = sum(1 for f in findings if f.severity == ERROR)
        extra = f", {len(waived)} waived" if waived else ""
        print(f"{len(findings)} finding(s), {n_err} error(s){extra}")
    return 1 if any(f.severity == ERROR for f in findings) else 0
