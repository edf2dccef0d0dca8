"""Findings, severities and the one-line renderer of the analysis tiers
(counterpart of ``paddle_tpu/analysis/diagnostics.py:26-84``).

A :class:`Finding` is one rule violation pinned to a ``file:line:col``
span, with its stable rule id, severity, message, the enclosing symbol
and a hint.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["ERROR", "WARNING", "INFO", "SEVERITIES", "severity_rank",
           "Finding", "format_text"]

ERROR = "error"
WARNING = "warning"
INFO = "info"

#: most severe first — index is the sort rank
SEVERITIES = (ERROR, WARNING, INFO)


def severity_rank(severity: str) -> int:
    """0 for error, 1 for warning, 2 for info (unknown sorts last)."""
    try:
        return SEVERITIES.index(severity)
    except ValueError:
        return len(SEVERITIES)


@dataclass
class Finding:
    rule_id: str          # stable id, e.g. "CK202"
    severity: str         # ERROR | WARNING | INFO
    message: str          # what is wrong, specific to this occurrence
    file: str = "<string>"
    line: int = 0         # 1-based
    col: int = 0          # 0-based, clang style in renders
    end_line: int = 0
    end_col: int = 0
    symbol: str = ""      # enclosing function or kernel ("" at module scope)
    hint: str = ""        # suggested fix

    def span(self) -> str:
        return f"{self.file}:{self.line}:{self.col + 1}"

    def sort_key(self):
        return (self.file, self.line, self.col,
                severity_rank(self.severity), self.rule_id)

    def to_dict(self) -> dict:
        return {"rule": self.rule_id, "severity": self.severity,
                "message": self.message, "file": self.file,
                "line": self.line, "col": self.col,
                "end_line": self.end_line, "end_col": self.end_col,
                "symbol": self.symbol, "hint": self.hint}


def format_text(f: Finding, show_hint: bool = True) -> str:
    """One clang-style diagnostic line (plus an indented hint line)."""
    sym = f" [in {f.symbol}]" if f.symbol else ""
    out = f"{f.span()}: {f.rule_id} {f.severity}: {f.message}{sym}"
    if show_hint and f.hint:
        out += f"\n    hint: {f.hint}"
    return out
