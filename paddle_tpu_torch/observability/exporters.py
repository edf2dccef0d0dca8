"""Telemetry exporters (counterpart of
``paddle_tpu/observability/exporters.py``): Prometheus text exposition and
the JSON snapshot.

All standard library, like the registry. The Prometheus renderer emits exactly
one ``# HELP`` + ``# TYPE`` pair per metric, series sorted by label set, so
output is deterministic (golden-testable) and scrapable by any Prometheus-
compatible agent tailing a file or hitting a debug endpoint.
"""

from __future__ import annotations

from .metrics import Counter, Gauge, Histogram, Registry, get_registry

__all__ = ["render_prometheus", "snapshot"]


def _esc_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _esc_label(s) -> str:
    return str(s).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _fmt_labels(key: tuple, extra: tuple = ()) -> str:
    pairs = list(key) + list(extra)
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{_esc_label(v)}"' for k, v in pairs) + "}"


def _fmt_value(v) -> str:
    f = float(v)
    if f.is_integer() and abs(f) < 2 ** 53:
        return str(int(f))
    return repr(f)


def render_prometheus(registry: Registry | None = None) -> str:
    """Prometheus text exposition (version 0.0.4) of every metric in the
    registry. Metrics with no samples still get their HELP/TYPE header so
    scrapers learn the full schema."""
    reg = registry or get_registry()
    lines: list[str] = []
    for m in reg.metrics():
        # help-less metrics get a bare "# HELP name" line: a trailing
        # space is a grammar violation under strict parsers
        help_txt = _esc_help(m.help)
        lines.append(f"# HELP {m.name} {help_txt}" if help_txt
                     else f"# HELP {m.name}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        if isinstance(m, (Counter, Gauge)):
            for key, v in m._items():
                lines.append(f"{m.name}{_fmt_labels(key)} {_fmt_value(v)}")
        elif isinstance(m, Histogram):
            for key, _ in m._items():
                agg = m.value(**dict(key))
                for le, c in agg["buckets"].items():
                    lines.append(
                        f"{m.name}_bucket"
                        f"{_fmt_labels(key, (('le', le),))} {c}")
                lines.append(
                    f"{m.name}_sum{_fmt_labels(key)} "
                    f"{_fmt_value(agg['sum'])}")
                lines.append(
                    f"{m.name}_count{_fmt_labels(key)} {agg['count']}")
    return "\n".join(lines) + ("\n" if lines else "")


def snapshot(registry: Registry | None = None) -> dict:
    """JSON-safe snapshot of every sampled metric (the ``metrics`` block of
    a flight dump)."""
    return (registry or get_registry()).snapshot()
