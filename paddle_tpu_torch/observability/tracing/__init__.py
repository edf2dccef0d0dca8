"""Per-request tracing for the serving path (counterpart of
``paddle_tpu/observability/tracing``, the port's own copy).

Every ``LLMEngine.submit`` opens a **root span** carrying a 128-bit trace
id, and the scheduler records **child spans** for each stage of the
request's life (queue wait, admission, prefill or its chunks, decode and
speculate iterations folded into bursts, eviction, copy-on-write copies,
stream emission). A slow TTFT becomes explainable: its histogram
exemplar names a trace id, and ``GET /trace/<id>`` returns the span tree.

* Standard library only.
* Off (``PADDLE_TPU_TRACE=0`` or :func:`enable` ``(False)``),
  :func:`start_request` returns the :data:`NOOP_TRACE` singleton whose
  methods return :data:`NOOP_SPAN`; hot call sites check
  ``trace is NOOP_TRACE``, one pointer comparison.
* The tracer times its own span-append path (``stats()["cost_s"]``).
* Bounded everywhere: the per-request span buffer
  (``PADDLE_TPU_TRACE_SPANS``), the completed-trace reservoir
  (``PADDLE_TPU_TRACE_RESERVOIR``), the request-log ring
  (``PADDLE_TPU_TRACE_REQUESTS``) and the live-trace table evict oldest
  first.
* Leaf locks: no code path calls back into the scheduler, the pool or the
  metrics registry while holding one, and the :class:`Tracer` lock and a
  :class:`RequestTrace` lock are never held together.

Context travels in the W3C ``traceparent`` format (``00-<32 hex trace
id>-<16 hex parent span id>-<2 hex flags>``); a malformed value gives a
fresh trace, never a failed request. The command line and the chrome-trace
export are not ported.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict, deque

__all__ = [
    "TraceContext",
    "parse_traceparent",
    "Span",
    "RequestTrace",
    "Tracer",
    "get_tracer",
    "tracing_enabled",
    "enable",
    "start_request",
    "get_trace",
    "requests",
    "open_spans",
    "note_exemplar",
    "exemplars",
    "flight_snapshot",
    "render_request_log",
    "stats",
    "reset",
    "decode_burst",
    "NOOP_TRACE",
    "NOOP_SPAN",
]

TRACEPARENT_VERSION = "00"

#: child-span names the serving path emits (the docs' span taxonomy)
SPAN_KINDS = ("queue_wait", "admit", "prefill", "prefill_chunk", "decode",
              "speculate", "evict", "cow", "stream")


def _env_int(name, default):
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _gen_trace_id() -> str:
    return os.urandom(16).hex()


def _gen_span_id() -> str:
    return os.urandom(8).hex()


def _is_hex(s: str) -> bool:
    try:
        int(s, 16)
    except ValueError:
        return False
    return s == s.lower()


class TraceContext:
    """Serializable trace position: (trace id, parent span id, flags)."""

    __slots__ = ("trace_id", "span_id", "flags")

    def __init__(self, trace_id: str, span_id: str, flags: int = 1):
        self.trace_id = trace_id
        self.span_id = span_id
        self.flags = int(flags)

    def to_traceparent(self) -> str:
        return (f"{TRACEPARENT_VERSION}-{self.trace_id}-{self.span_id}"
                f"-{self.flags & 0xFF:02x}")

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"TraceContext({self.to_traceparent()!r})"


def parse_traceparent(value) -> TraceContext | None:
    """Parse a W3C ``traceparent`` header. Returns ``None`` (never
    raises) on anything malformed — a bad inbound header must degrade to
    a fresh trace, not fail the request."""
    if not isinstance(value, str):
        return None
    parts = value.strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if len(version) != 2 or not _is_hex(version) or version == "ff":
        return None
    if len(trace_id) != 32 or not _is_hex(trace_id) or set(trace_id) == {"0"}:
        return None
    if len(span_id) != 16 or not _is_hex(span_id) or set(span_id) == {"0"}:
        return None
    if len(flags) != 2 or not _is_hex(flags):
        return None
    return TraceContext(trace_id, span_id, int(flags, 16))


class Span:
    """One timed, attributed interval inside a request trace."""

    __slots__ = ("name", "span_id", "parent_id", "t_start", "t_end",
                 "attributes", "_trace")

    def __init__(self, name, parent_id=None, t_start=None, attributes=None,
                 _trace=None):
        self.name = name
        self.span_id = _gen_span_id()
        self.parent_id = parent_id
        self.t_start = time.time() if t_start is None else float(t_start)
        self.t_end = None
        self.attributes = dict(attributes) if attributes else {}
        self._trace = _trace

    def set(self, **attrs) -> "Span":
        self.attributes.update(attrs)
        return self

    def end(self, t_end=None, **attrs) -> None:
        if attrs:
            self.attributes.update(attrs)
        tr = self._trace
        if tr is not None:
            tr._end_span(self, t_end)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None and "error" not in self.attributes:
            self.attributes["error"] = repr(exc)
        self.end()

    def to_dict(self) -> dict:
        d = {"name": self.name, "span_id": self.span_id,
             "parent_id": self.parent_id, "t_start": self.t_start,
             "t_end": self.t_end}
        if self.attributes:
            d["attributes"] = dict(self.attributes)
        return d


class _NoopSpan:
    """Disabled-mode span: every method is a no-op returning a singleton
    (type identity: ``trace.span(...) is NOOP_SPAN`` always holds)."""

    __slots__ = ()
    name = None
    span_id = None
    parent_id = None
    t_start = None
    t_end = None
    attributes: dict = {}

    def set(self, **attrs):
        return self

    def end(self, t_end=None, **attrs):
        return None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None

    def to_dict(self):
        return {}


class _NoopTrace:
    """Disabled-mode request trace (singleton, see :data:`NOOP_TRACE`)."""

    __slots__ = ()
    trace_id = None
    request_id = None

    def context(self):
        return None

    def span(self, name, parent=None, t_start=None, **attrs):
        return NOOP_SPAN

    def add_span(self, name, t_start, t_end, parent=None, **attrs):
        return NOOP_SPAN

    def finish(self, state="completed", **fields):
        return None

    def snapshot(self):
        return {}

    def open_spans(self):
        return []


NOOP_SPAN = _NoopSpan()
NOOP_TRACE = _NoopTrace()


class RequestTrace:
    """Span buffer for one request: a root span plus a bounded list of
    children. Thread-safe; the lock is a leaf (methods never call out
    of this module while holding it)."""

    def __init__(self, tracer, request_id=None, name="request",
                 parent: TraceContext | None = None, max_spans=256,
                 attributes=None):
        self._tracer = tracer
        self._lock = threading.Lock()
        self.trace_id = parent.trace_id if parent else _gen_trace_id()
        self.request_id = request_id
        self.max_spans = int(max_spans)
        self.root = Span(name, parent_id=parent.span_id if parent else None,
                         attributes=attributes, _trace=self)
        if request_id is not None:
            self.root.attributes.setdefault("request_id", request_id)
        self._spans: list[Span] = []      # finished children, bounded
        self._open: dict[str, Span] = {}  # span_id -> open child
        self._dropped = 0
        self._cost_s = 0.0
        self._finished = False

    # -- span lifecycle -------------------------------------------------
    def context(self) -> TraceContext:
        """Context to propagate downstream (child of the root span)."""
        return TraceContext(self.trace_id, self.root.span_id)

    def span(self, name, parent=None, t_start=None, **attrs) -> Span:
        """Open a child span (ended via ``.end()`` / context manager)."""
        t0 = time.perf_counter()
        parent_id = parent.span_id if parent is not None else self.root.span_id
        s = Span(name, parent_id=parent_id, t_start=t_start,
                 attributes=attrs or None, _trace=self)
        with self._lock:
            if self._finished or \
                    len(self._spans) + len(self._open) >= self.max_spans:
                self._dropped += 1
                s._trace = None  # still usable, just not recorded
            else:
                self._open[s.span_id] = s
            self._cost_s += time.perf_counter() - t0
        return s

    def add_span(self, name, t_start, t_end, parent=None, **attrs) -> Span:
        """Record an already-timed span in one call (burst flushes)."""
        t0 = time.perf_counter()
        parent_id = parent.span_id if parent is not None else self.root.span_id
        s = Span(name, parent_id=parent_id, t_start=t_start,
                 attributes=attrs or None, _trace=None)
        s.t_end = float(t_end)
        with self._lock:
            if self._finished or len(self._spans) >= self.max_spans:
                self._dropped += 1
            else:
                self._spans.append(s)
            self._cost_s += time.perf_counter() - t0
        return s

    def _end_span(self, span: Span, t_end=None) -> None:
        t0 = time.perf_counter()
        end = time.time() if t_end is None else float(t_end)
        with self._lock:
            if span.t_end is None:
                span.t_end = end
            live = self._open.pop(span.span_id, None)
            if live is not None and not self._finished and \
                    len(self._spans) < self.max_spans:
                self._spans.append(span)
            elif live is not None:
                self._dropped += 1
            self._cost_s += time.perf_counter() - t0

    def finish(self, state="completed", **fields) -> dict | None:
        """Close the root span, build the request record and hand the
        trace to the tracer's reservoir + request log. Idempotent."""
        t0 = time.perf_counter()
        now = time.time()
        with self._lock:
            if self._finished:
                return None
            self._finished = True
            self.root.t_end = now
            # a still-open child at finish is a bug upstream, but the
            # trace must stay renderable: close it at root end
            for s in self._open.values():
                s.t_end = now
                s.attributes.setdefault("unfinished", True)
                if len(self._spans) < self.max_spans:
                    self._spans.append(s)
                else:
                    self._dropped += 1
            self._open.clear()
            spans = list(self._spans)
            dropped = self._dropped
            self._cost_s += time.perf_counter() - t0
            cost_s = self._cost_s
        record = self._build_record(state, spans, dropped, fields)
        # tracer lock taken strictly after the trace lock was released:
        # the two lock classes are never nested in either order
        self._tracer._complete(self, record, len(spans), cost_s)
        return record

    # -- introspection --------------------------------------------------
    def _build_record(self, state, spans, dropped, fields) -> dict:
        root = self.root
        e2e_s = (root.t_end or time.time()) - root.t_start
        record = {
            "trace_id": self.trace_id,
            "request_id": self.request_id,
            "state": state,
            "t_start": root.t_start,
            "t_end": root.t_end,
            "e2e_ms": round(e2e_s * 1000.0, 3),
            "spans": len(spans),
            "dropped_spans": dropped,
            "span_kinds": sorted({s.name for s in spans}),
            "span_coverage": round(_coverage(root, spans), 4),
        }
        proposed = sum(s.attributes.get("proposed", 0) for s in spans
                       if s.name == "speculate")
        if proposed:
            record["spec"] = {
                "proposed": proposed,
                "accepted": sum(s.attributes.get("accepted", 0)
                                for s in spans if s.name == "speculate")}
        for k, v in fields.items():
            if v is not None:
                record[k] = v
        return record

    def snapshot(self) -> dict:
        """Full span tree (finished + still-open children)."""
        with self._lock:
            spans = [s.to_dict() for s in self._spans]
            open_ = [s.to_dict() for s in self._open.values()]
            dropped = self._dropped
        d = {"trace_id": self.trace_id, "request_id": self.request_id,
             "root": self.root.to_dict(), "spans": spans}
        if open_:
            d["open"] = open_
        if dropped:
            d["dropped_spans"] = dropped
        return d

    def open_spans(self) -> list[dict]:
        """Spans without an end time (root included while unfinished),
        each stamped with trace/request ids — this is what a flight dump
        carries for an in-flight request at death."""
        out = []
        with self._lock:
            if self._finished:
                return out
            for s in [self.root] + list(self._open.values()):
                d = s.to_dict()
                d["trace_id"] = self.trace_id
                d["request_id"] = self.request_id
                out.append(d)
        return out


def _coverage(root, spans) -> float:
    """Fraction of the root span's wall covered by the union of child
    span intervals (``span_coverage`` in the request record)."""
    t0, t1 = root.t_start, root.t_end or time.time()
    if t1 <= t0:
        return 1.0 if spans else 0.0
    ivals = []
    for s in spans:
        a = max(s.t_start, t0)
        b = min(s.t_end if s.t_end is not None else t1, t1)
        if b > a:
            ivals.append((a, b))
    ivals.sort()
    covered = 0.0
    cur_a = cur_b = None
    for a, b in ivals:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                covered += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        covered += cur_b - cur_a
    return min(1.0, covered / (t1 - t0))


class Tracer:
    """Process-global trace collector: live traces, a sampled reservoir
    of completed traces, a ring of request-log records and histogram
    exemplars. All state behind one leaf lock."""

    def __init__(self, enabled=None, max_spans=None, reservoir=None,
                 log_capacity=None, sample_every=None):
        if enabled is None:
            enabled = os.environ.get("PADDLE_TPU_TRACE", "1") != "0"
        self.enabled = bool(enabled)
        self.max_spans = max_spans if max_spans is not None else \
            _env_int("PADDLE_TPU_TRACE_SPANS", 256)
        self.reservoir_capacity = reservoir if reservoir is not None else \
            _env_int("PADDLE_TPU_TRACE_RESERVOIR", 256)
        self.log_capacity = log_capacity if log_capacity is not None else \
            _env_int("PADDLE_TPU_TRACE_REQUESTS", 512)
        #: keep every Nth completed trace's full span tree (the request
        #: log line is always written); deterministic counter sampling
        self.sample_every = max(1, sample_every if sample_every is not None
                                else _env_int("PADDLE_TPU_TRACE_SAMPLE", 1))
        self._lock = threading.Lock()
        self._live: "OrderedDict[str, RequestTrace]" = OrderedDict()
        self._live_capacity = max(64, self.reservoir_capacity * 4)
        self._reservoir: "OrderedDict[str, dict]" = OrderedDict()
        self._log: deque = deque(maxlen=self.log_capacity)
        self._exemplars: dict[str, dict] = {}
        self._completions = 0
        self._spans_total = 0
        self._dropped_live = 0
        self._cost_s = 0.0

    # -- request lifecycle ----------------------------------------------
    def start_request(self, request_id=None, traceparent=None, **attrs):
        """Open a root span. Returns :data:`NOOP_TRACE` when disabled
        (identity-checkable by hot call sites). A malformed
        ``traceparent`` yields a fresh trace, never an error."""
        if not self.enabled:
            return NOOP_TRACE
        parent = parse_traceparent(traceparent) if traceparent else None
        tr = RequestTrace(self, request_id=request_id, parent=parent,
                          max_spans=self.max_spans, attributes=attrs or None)
        with self._lock:
            self._live[tr.trace_id] = tr
            while len(self._live) > self._live_capacity:
                self._live.popitem(last=False)
                self._dropped_live += 1
        return tr

    def _complete(self, tr, record, n_spans, cost_s) -> None:
        with self._lock:
            self._live.pop(tr.trace_id, None)
            self._completions += 1
            self._spans_total += n_spans
            self._cost_s += cost_s
            self._log.append(record)
            if (self._completions - 1) % self.sample_every == 0:
                self._reservoir[tr.trace_id] = None  # snapshot outside lock
                while len(self._reservoir) > self.reservoir_capacity:
                    self._reservoir.popitem(last=False)
            keep = tr.trace_id in self._reservoir
        if keep:
            snap = tr.snapshot()
            snap["record"] = record
            with self._lock:
                if tr.trace_id in self._reservoir:
                    self._reservoir[tr.trace_id] = snap

    # -- lookups ---------------------------------------------------------
    def get_trace(self, trace_id) -> dict | None:
        """Span tree for a trace id: completed (reservoir) or live."""
        with self._lock:
            snap = self._reservoir.get(trace_id)
            live = self._live.get(trace_id)
        if snap is not None:
            return snap
        if live is not None:
            return live.snapshot()
        return None

    def requests(self, last=None) -> list[dict]:
        """Most recent request-log records, oldest first."""
        with self._lock:
            out = list(self._log)
        if last is not None and last >= 0:
            out = out[-last:]
        return out

    def open_spans(self) -> list[dict]:
        """Open spans of every in-flight trace (flight-dump payload)."""
        with self._lock:
            live = list(self._live.values())
        out = []
        for tr in live:
            out.extend(tr.open_spans())
        return out

    # -- exemplars --------------------------------------------------------
    def note_exemplar(self, metric, value, trace_id, buckets=()) -> None:
        """Link ``value`` observed on ``metric`` to a trace id, keyed by
        the histogram bucket it falls in (latest observation per bucket
        wins; bounded by the bucket count)."""
        if trace_id is None:
            return
        le = "+Inf"
        for b in buckets:
            if value <= b:
                le = b
                break
        with self._lock:
            self._exemplars.setdefault(metric, {})[str(le)] = {
                "bucket_le": le, "value": round(float(value), 3),
                "trace_id": trace_id, "t": time.time()}

    def exemplars(self) -> dict:
        """Per metric: exemplar per occupied bucket plus a ``top``
        pointer at the highest occupied bucket (the p99 explainer)."""
        with self._lock:
            snap = {m: dict(bs) for m, bs in self._exemplars.items()}
        out = {}
        for metric, bs in snap.items():
            def _key(item):
                le = item[1]["bucket_le"]
                return float("inf") if le == "+Inf" else float(le)
            top = max(bs.items(), key=_key)[1]
            out[metric] = {"buckets": bs, "top": top}
        return out

    # -- maintenance ------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            n_spans = self._spans_total
            cost = self._cost_s
            return {
                "enabled": self.enabled,
                "live": len(self._live),
                "reservoir": len(self._reservoir),
                "completions": self._completions,
                "spans_total": n_spans,
                "dropped_live": self._dropped_live,
                "cost_s": round(cost, 6),
                "span_cost_us": round(cost / n_spans * 1e6, 3)
                if n_spans else 0.0,
            }

    def flight_snapshot(self) -> dict:
        """Bounded payload the flight recorder embeds in every dump:
        open spans of in-flight requests + a tail of recent traces."""
        with self._lock:
            recent = [s for s in list(self._reservoir.values())[-8:]
                      if s is not None]
            log_tail = list(self._log)[-16:]
        return {"open_spans": self.open_spans(), "traces": recent,
                "requests": log_tail, "stats": self.stats()}

    def reset(self) -> None:
        with self._lock:
            self._live.clear()
            self._reservoir.clear()
            self._log.clear()
            self._exemplars.clear()
            self._completions = 0
            self._spans_total = 0
            self._dropped_live = 0
            self._cost_s = 0.0


_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def tracing_enabled() -> bool:
    return _TRACER.enabled


def enable(on: bool = True) -> None:
    """Flip tracing at runtime (``PADDLE_TPU_TRACE`` sets the default).
    Already-open traces keep recording; new requests observe the flag."""
    _TRACER.enabled = bool(on)


def start_request(request_id=None, traceparent=None, **attrs):
    return _TRACER.start_request(request_id=request_id,
                                 traceparent=traceparent, **attrs)


def get_trace(trace_id):
    return _TRACER.get_trace(trace_id)


def requests(last=None):
    return _TRACER.requests(last)


def open_spans():
    return _TRACER.open_spans()


def note_exemplar(metric, value, trace_id, buckets=()):
    _TRACER.note_exemplar(metric, value, trace_id, buckets)


def exemplars():
    return _TRACER.exemplars()


def flight_snapshot():
    return _TRACER.flight_snapshot()


def stats():
    return _TRACER.stats()


def reset():
    _TRACER.reset()


#: burst length for decode/speculate span aggregation (spans per burst)
def decode_burst() -> int:
    return max(1, _env_int("PADDLE_TPU_TRACE_BURST", 32))


# ---------------------------------------------------------------------------
# Exporters


def render_request_log(last=None) -> str:
    """The structured request log: one strict-JSON (RFC 8259) line per
    completed request, sanitised with the flight recorder's encoders."""
    from .. import flight as _flight
    lines = []
    for rec in _TRACER.requests(last):
        lines.append(json.dumps(_flight._finite(rec), sort_keys=True,
                                allow_nan=False,
                                default=_flight._json_safe))
    return "\n".join(lines) + ("\n" if lines else "")
