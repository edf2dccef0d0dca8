"""Runtime telemetry registry: Counter / Gauge / Histogram (counterpart
of ``paddle_tpu/observability/metrics.py``, the port's own copy).

Standard library only: every hot layer of the port may import it at its
own import time.

Naming convention: ``paddle_tpu_<area>_<name>_<unit>``, the JAX package's
names (``paddle_tpu_serving_tokens_total``, ``paddle_tpu_serving_ttft_ms``),
so dashboards and scrapers read either package. Counters end in
``_total``; histograms and gauges end in their unit.

Overhead: when disabled (``PADDLE_TPU_METRICS=0`` in the environment, or
``enable(False)`` at runtime) every mutation method returns after one
attribute load and a bool test: no lock, no dict access.

Thread safety: each metric owns one lock over its label->value table; the
registry owns a lock for get-or-create. Exporters copy under the same
lock.

Cardinality guard: a per-metric series cap
(``PADDLE_TPU_METRICS_MAX_SERIES``, default 256) bounds the label table.
Once a metric is at its cap, samples for NEW label sets fold into one
``overflow="true"`` sink series (existing series keep recording exactly),
and a one-time warning names the metric.
"""

from __future__ import annotations

import os
import re
import threading
import time
import warnings
from bisect import bisect_left
from collections import deque


__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "DEFAULT_BUCKETS",
    "DEFAULT_MAX_SERIES", "OVERFLOW_KEY",
    "get_registry", "counter", "gauge", "histogram",
    "enabled", "enable", "value", "total", "reset",
]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: label set every over-cap sample folds into
OVERFLOW_KEY = (("overflow", "true"),)

DEFAULT_MAX_SERIES = 256

#: windowed-rate history: one (monotonic, cumulative) snapshot at most
#: every RATE_TICK_S per labeled series, RATE_SLOTS deep, so rate()/
#: delta() can window ~RATE_TICK_S * RATE_SLOTS = 64s of history —
#: enough for the /healthz 30s steps/s window with slack.
RATE_TICK_S = 0.25
RATE_SLOTS = 256

#: injectable clock (tests patch this; monotonic so wall-clock jumps
#: cannot produce negative windows)
_monotonic = time.monotonic


def _env_max_series() -> int:
    try:
        return max(int(os.environ.get("PADDLE_TPU_METRICS_MAX_SERIES",
                                      DEFAULT_MAX_SERIES)), 1)
    except ValueError:
        return DEFAULT_MAX_SERIES


def _env_enabled() -> bool:
    return os.environ.get("PADDLE_TPU_METRICS", "1").lower() not in (
        "0", "false", "off")


class _State:
    __slots__ = ("enabled",)

    def __init__(self):
        self.enabled = _env_enabled()


_state = _State()


def enabled() -> bool:
    """True while telemetry collection is on (``PADDLE_TPU_METRICS`` env,
    overridable at runtime via :func:`enable`)."""
    return _state.enabled


def enable(flag: bool = True) -> bool:
    """Turn collection on/off process-wide; returns the new state."""
    _state.enabled = bool(flag)
    return _state.enabled


def _label_key(labels: dict) -> tuple:
    if not labels:
        return ()
    return tuple(sorted(labels.items()))


def _mutation_key(labels: dict) -> tuple:
    """Label key for WRITE paths: the ``overflow`` label is reserved for
    the cardinality-guard sink — user data recorded under it would mix
    indistinguishably with folded over-cap spill. Reads (``value()``)
    stay permitted so the sink is queryable."""
    if labels and "overflow" in labels:
        raise ValueError(
            "label name 'overflow' is reserved for the cardinality-guard "
            "sink series")
    return _label_key(labels)


class MetricBase:
    """Shared storage: a lock-guarded ``{sorted-label-tuple: value}`` table."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", windowed: bool = False):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help
        # rate()/delta() history is OPT-IN: every tick costs a clock read
        # plus ring upkeep on the mutation path, and most of the registry's
        # hot counters (collective bytes, retraces, prefetch) are only ever
        # scraped cumulatively
        self.windowed = bool(windowed)
        self._lock = threading.Lock()
        self._values: dict = {}
        self._ticks: dict = {}   # key -> deque[(monotonic, cumulative)]
        self.max_series = _env_max_series()
        self._overflowed = False

    def _slot(self, key: tuple) -> tuple:
        """Cardinality guard; call under ``self._lock``. Existing series
        and under-cap inserts pass through; a NEW label set on a metric at
        cap folds into :data:`OVERFLOW_KEY` (the sink series itself is
        exempt from the cap, so the spill is never dropped)."""
        if key in self._values or len(self._values) < self.max_series \
                or key == OVERFLOW_KEY:
            return key
        if not self._overflowed:
            self._overflowed = True
            warnings.warn(
                f"metric {self.name!r} hit its label-cardinality cap "
                f"({self.max_series} series; PADDLE_TPU_METRICS_MAX_SERIES); "
                f'new label sets now fold into the overflow="true" series',
                RuntimeWarning, stacklevel=3)
        return OVERFLOW_KEY

    def clear(self):
        with self._lock:
            self._values.clear()
            self._ticks.clear()

    # -- windowed rates (Counter/Histogram opt in via _cum_of) ---------------

    def _note_tick(self, key: tuple, cum: float):
        """Under ``self._lock``: snapshot the cumulative value for the
        rate window (``windowed=True`` metrics only). Snapshots within
        RATE_TICK_S of the last collapse into it (value updated, timestamp
        kept) so a hot series costs one clock read per mutation, not one
        ring slot."""
        if not self.windowed:
            return
        dq = self._ticks.get(key)
        if dq is None:
            dq = self._ticks[key] = deque(maxlen=RATE_SLOTS)
        now = _monotonic()
        if dq and now - dq[-1][0] < RATE_TICK_S:
            dq[-1] = (dq[-1][0], cum)
        else:
            dq.append((now, cum))

    def _window_base(self, key: tuple, window: float):
        """Under ``self._lock``: (base_time, base_value) — the newest
        snapshot at least ``window`` old, else the oldest available
        (partial window). None when no history exists."""
        dq = self._ticks.get(key)
        if not dq:
            return None
        now = _monotonic()
        base = dq[0]
        for t, v in reversed(dq):
            if now - t >= window:
                base = (t, v)
                break
        return base

    def _windowed(self, window: float, labels: dict):
        """(delta, elapsed_seconds) of the cumulative value over (up to)
        the last ``window`` seconds; (0.0, 0.0) without enough history."""
        key = _label_key(labels)
        with self._lock:
            base = self._window_base(key, window)
            if base is None:
                return 0.0, 0.0
            cum = self._cum_of(key)
        elapsed = _monotonic() - base[0]
        if elapsed <= 0:
            return 0.0, 0.0
        return max(cum - base[1], 0.0), elapsed

    def _cum_of(self, key: tuple) -> float:
        raise TypeError(
            f"windowed rate is not defined for {self.kind} metrics")

    def _items(self):
        with self._lock:
            return sorted(self._values.items())

    def series(self) -> list:
        """``[(labels_dict, value)]`` per labeled series — the structured
        form of ``snapshot()["values"]``, for consumers that would
        otherwise reverse-parse the formatted label strings."""
        return [(dict(k), v) for k, v in self._items()]

    def snapshot(self) -> dict:
        return {"type": self.kind, "help": self.help,
                "values": {_format_labels(k): v for k, v in self._items()}}


def _format_labels(key: tuple) -> str:
    """Stable string form of one label set for JSON snapshots: ``fn="f"``
    pairs joined by commas, empty string for the unlabeled series."""
    return ",".join(f'{k}="{v}"' for k, v in key)


class Counter(MetricBase):
    kind = "counter"

    def inc(self, value: float = 1, /, **labels):
        if not _state.enabled:
            return
        if value < 0:
            raise ValueError("counters only go up; use a Gauge")
        key = _mutation_key(labels)
        with self._lock:
            key = self._slot(key)
            cum = self._values[key] = self._values.get(key, 0) + value
            self._note_tick(key, cum)

    def value(self, /, **labels):
        with self._lock:
            return self._values.get(_label_key(labels), 0)

    def total(self):
        with self._lock:
            return sum(self._values.values())

    def _cum_of(self, key):
        return self._values.get(key, 0)

    def rate(self, window: float = 60.0, /, **labels) -> float:
        """Counter increase per second over (up to) the last ``window``
        seconds — /healthz-grade steps/s without scrape-side math. Needs
        the history to actually span time: 0.0 with fewer than two
        snapshot ticks (resolution RATE_TICK_S, depth RATE_SLOTS)."""
        delta, elapsed = self._windowed(window, labels)
        return delta / elapsed if elapsed > 0 else 0.0

    def delta(self, window: float = 60.0, /, **labels) -> float:
        """Raw counter increase over (up to) the last ``window`` seconds
        (the un-divided form of :meth:`rate`)."""
        return self._windowed(window, labels)[0]


class Gauge(MetricBase):
    kind = "gauge"

    def set(self, value: float, /, **labels):
        if not _state.enabled:
            return
        key = _mutation_key(labels)
        with self._lock:
            key = self._slot(key)
            self._values[key] = value

    def inc(self, value: float = 1, /, **labels):
        if not _state.enabled:
            return
        key = _mutation_key(labels)
        with self._lock:
            key = self._slot(key)
            self._values[key] = self._values.get(key, 0) + value

    def dec(self, value: float = 1, /, **labels):
        self.inc(-value, **labels)

    def value(self, /, **labels):
        with self._lock:
            return self._values.get(_label_key(labels), 0)


# Prometheus-style latency buckets, in seconds.
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Histogram(MetricBase):
    """Fixed-bucket histogram. Buckets are upper bounds (inclusive, the
    Prometheus ``le`` contract) plus an implicit +Inf overflow slot.
    Per-label storage is ``[per-bucket counts, sum, count]``; cumulative
    counts are materialized only at export time."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", buckets=DEFAULT_BUCKETS,
                 windowed: bool = False):
        super().__init__(name, help, windowed=windowed)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = bs

    def observe(self, value: float, /, **labels):
        if not _state.enabled:
            return
        key = _mutation_key(labels)
        with self._lock:
            key = self._slot(key)
            row = self._values.get(key)
            if row is None:
                row = self._values[key] = [
                    [0] * (len(self.buckets) + 1), 0.0, 0]
            row[0][bisect_left(self.buckets, value)] += 1
            row[1] += value
            row[2] += 1
            self._note_tick(key, row[2])

    def value(self, /, **labels) -> dict:
        """``{"count", "sum", "buckets"}`` with CUMULATIVE bucket counts
        keyed by the ``le`` bound (``repr(float)`` form, plus ``+Inf``)."""
        with self._lock:
            row = self._values.get(_label_key(labels))
            if row is None:
                return {"count": 0, "sum": 0.0, "buckets": {}}
            counts, s, n = list(row[0]), row[1], row[2]
        out, acc = {}, 0
        for b, c in zip(self.buckets, counts):
            acc += c
            out[repr(b)] = acc
        out["+Inf"] = acc + counts[-1]
        return {"count": n, "sum": s, "buckets": out}

    def quantile(self, q: float, /, **labels):
        """Approximate ``q``-quantile by linear interpolation inside the
        owning bucket (the Prometheus ``histogram_quantile`` estimate,
        anchored at 0 below the first bound). None when the series has no
        observations. Overflow-bucket hits return the top finite bound —
        a lower bound on the true quantile, still gate-worthy. The serving
        ``timing_split`` p50s read it."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile wants 0 <= q <= 1, got {q}")
        v = self.value(**labels)
        n = v["count"]
        if not n:
            return None
        target = q * n
        prev_le, prev_acc = 0.0, 0
        for le, acc in v["buckets"].items():
            if le == "+Inf":
                continue
            bound = float(le)
            if acc >= target:
                span = acc - prev_acc
                frac = (target - prev_acc) / span if span else 1.0
                return prev_le + (bound - prev_le) * frac
            prev_le, prev_acc = bound, acc
        return prev_le

    def snapshot(self) -> dict:
        vals = {}
        with self._lock:
            keys = sorted(self._values)
        for k in keys:
            vals[_format_labels(k)] = self.value(**dict(k))
        return {"type": self.kind, "help": self.help,
                "buckets": [repr(b) for b in self.buckets], "values": vals}

    def _cum_of(self, key):
        row = self._values.get(key)
        return row[2] if row is not None else 0

    def rate(self, window: float = 60.0, /, **labels) -> float:
        """Observations per second over (up to) the last ``window``
        seconds. Same snapshot semantics as
        :meth:`Counter.rate`."""
        delta, elapsed = self._windowed(window, labels)
        return delta / elapsed if elapsed > 0 else 0.0

    def delta(self, window: float = 60.0, /, **labels) -> float:
        """Raw observation-count increase over (up to) the last
        ``window`` seconds."""
        return self._windowed(window, labels)[0]


_METRIC_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Registry:
    """Get-or-create store of metrics by name. Creating the same name twice
    returns the existing object; asking for it under a different type
    raises (one name, one type — the Prometheus exposition contract)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, MetricBase] = {}

    def _get_or_create(self, cls, name, help, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise TypeError(
                        f"metric {name!r} already registered as {m.kind}, "
                        f"requested {cls.kind}")
                want = kw.get("buckets")
                if want is not None and \
                        tuple(sorted(float(b) for b in want)) != m.buckets:
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"buckets {m.buckets}, requested "
                        f"{tuple(sorted(float(b) for b in want))}")
                if kw.get("windowed") and not m.windowed:
                    # a later windowed=True request arms it. A PLAIN
                    # write on purpose: a monotonic one-way bool flip
                    # (worst case one missed rate tick) — taking
                    # m._lock here, inside the registry critical
                    # section, would mint a registry→metric lock order
                    # no other path needs
                    m.windowed = True
                return m
            kw = {k: v for k, v in kw.items() if v is not None}
            m = self._metrics[name] = cls(name, help, **kw)
            return m

    def counter(self, name: str, help: str = "",
                windowed: bool = False) -> Counter:
        return self._get_or_create(Counter, name, help,
                                   windowed=windowed or None)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "", buckets=None,
                  windowed: bool = False) -> Histogram:
        """Get-or-create a histogram. buckets=None accepts an existing
        metric's bounds (DEFAULT_BUCKETS when creating); explicit buckets
        must MATCH an already-registered metric's bounds or this raises —
        silently binning into bounds the caller never asked for would
        corrupt the data."""
        return self._get_or_create(Histogram, name, help, buckets=buckets,
                                   windowed=windowed or None)

    def get(self, name: str) -> MetricBase | None:
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> list[MetricBase]:
        with self._lock:
            return [self._metrics[n] for n in sorted(self._metrics)]

    def snapshot(self) -> dict:
        """JSON-safe ``{name: metric.snapshot()}``, names sorted. Series
        that never recorded a sample are omitted (a registered-but-silent
        metric carries no information)."""
        out = {}
        for m in self.metrics():
            snap = m.snapshot()
            if snap["values"]:
                out[m.name] = snap
        return out

    def value(self, name: str, /, **labels):
        m = self.get(name)
        if m is None:
            return 0
        return m.value(**labels)

    def total(self, name: str):
        """Sum of a counter across all label sets (0 for unknown names)."""
        m = self.get(name)
        if m is None:
            return 0
        if isinstance(m, Counter):
            return m.total()
        raise TypeError(f"total() is only defined for counters, "
                        f"{name!r} is a {m.kind}")

    def reset(self):
        """Zero every metric's samples; registered metric OBJECTS survive,
        so module-level handles held by instrumentation stay live."""
        for m in self.metrics():
            m.clear()


_default_registry = Registry()


def get_registry() -> Registry:
    """The process-wide default registry all framework instrumentation
    records into."""
    return _default_registry


def counter(name: str, help: str = "", windowed: bool = False) -> Counter:
    return _default_registry.counter(name, help, windowed=windowed)


def gauge(name: str, help: str = "") -> Gauge:
    return _default_registry.gauge(name, help)


def histogram(name: str, help: str = "", buckets=None,
              windowed: bool = False) -> Histogram:
    return _default_registry.histogram(name, help, buckets=buckets,
                                       windowed=windowed)


def value(name: str, /, **labels):
    return _default_registry.value(name, **labels)


def total(name: str):
    return _default_registry.total(name)


def reset():
    _default_registry.reset()
