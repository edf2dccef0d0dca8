"""Flight recorder (counterpart of ``paddle_tpu/observability/flight``,
the port's own copy): a bounded, thread-safe ring buffer of structured
events that the serving path feeds through one :func:`record` call, and a
self-contained JSON dump of it when the process dies (the serving
engine's SIGTERM preemption dumps with reason ``serving_preempted``).

* Standard library only.
* Recording one event costs one dict build and one deque append, with NO
  lock on the hot path: ``deque.append`` (bounded by ``maxlen``) and
  ``itertools.count`` are atomic under the GIL and safe from a signal
  handler, where a held lock would deadlock.
* Disabled (``PADDLE_TPU_FLIGHT=0`` or ``enable(False)``), :func:`record`
  returns after one attribute load and a bool test; hot call sites also
  guard with ``if flight.enabled():`` so not even the kwargs dict is
  built.

Event schema: a flat JSON-safe dict ``{"seq": int, "t": epoch seconds,
"kind": str, **fields}``; the serving kinds are ``serving_submit``,
``serving_prefix_hit``, ``serving_prefill``, ``serving_decode``,
``serving_cow``, ``serving_evict``, ``serving_complete``,
``serving_spec_propose`` / ``_verify`` / ``_rollback``,
``serving_engine_error``, ``serving_drain``, ``serving_preempt`` and
``serving_drain_timeout``. :func:`render` gives a dump's human-readable
view. The command line and the chrome-trace conversion are not ported.
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time
from collections import deque

__all__ = [
    "FlightRecorder", "DEFAULT_CAPACITY", "SCHEMA_VERSION",
    "get_recorder", "record", "events", "clear", "enabled", "enable",
    "set_dump_dir", "get_dump_dir", "dump", "last_dump_path",
    "load_dump", "render",
]

DEFAULT_CAPACITY = 4096
SCHEMA_VERSION = 1


def _env_enabled() -> bool:
    return os.environ.get("PADDLE_TPU_FLIGHT", "1").lower() not in (
        "0", "false", "off")


def _env_capacity() -> int:
    try:
        return max(int(os.environ.get("PADDLE_TPU_FLIGHT_EVENTS",
                                      DEFAULT_CAPACITY)), 16)
    except ValueError:
        return DEFAULT_CAPACITY


class FlightRecorder:
    """Bounded event tape. ``capacity`` is the ring size (oldest events
    fall off); ``enabled`` gates recording, not dumping."""

    def __init__(self, capacity: int | None = None,
                 enabled: bool | None = None):
        self.capacity = _env_capacity() if capacity is None else int(capacity)
        self.enabled = _env_enabled() if enabled is None else bool(enabled)
        self._events: deque = deque(maxlen=self.capacity)
        self._seq = itertools.count()
        self.dump_dir: str | None = None
        self.last_dump_path: str | None = None
        # dumping IS locked: it's cold, and two death paths racing (e.g.
        # the signal handler and the engine thread) must not interleave writes
        self._dump_lock = threading.Lock()

    # -- hot path ------------------------------------------------------------

    def record(self, kind: str, **fields) -> None:
        """Append one structured event. ~one dict + one atomic append when
        enabled; a single attribute test when disabled. Signal-safe."""
        if not self.enabled:
            return
        fields["seq"] = next(self._seq)
        fields["t"] = time.time()
        fields["kind"] = kind
        self._events.append(fields)

    # -- reads ---------------------------------------------------------------

    def events(self, last: int | None = None) -> list:
        """Snapshot of the tape, oldest first (``last`` trims to the most
        recent N; 0 means none). list(deque) is atomic under the GIL."""
        snap = list(self._events)
        if last is None:
            return snap
        return snap[-last:] if last > 0 else []

    def clear(self) -> None:
        self._events.clear()

    def __len__(self) -> int:
        return len(self._events)

    # -- dump ----------------------------------------------------------------

    def dump(self, reason: str, step: int | None = None,
             path: str | None = None, extra: dict | None = None,
             last: int | None = None,
             dump_dir: str | None = None) -> str | None:
        """Write a self-contained forensic dump and return its path.

        Contents: schema/reason/step/time, the event tape (last-N), the
        metrics snapshot (``observability.exporters.snapshot``), the
        request tracer's open spans and request-log tail, and an
        env/config fingerprint. ``dump_dir`` overrides the recorder-wide
        directory for this one dump. Returns None when the recorder is
        disabled (no forensics were requested) or the write itself fails —
        a dying process must never die *again* in its black box."""
        if not self.enabled:
            return None
        with self._dump_lock:
            try:
                payload = self._payload(reason, step, extra, last)
                if path is None:
                    d = self._dir(dump_dir)
                    stem = f"flight_{int(step)}" if step is not None \
                        else "flight_final"
                    path = os.path.join(d, f"{stem}.json")
                    n = 2
                    while os.path.exists(path):
                        # never clobber an earlier black box at the same
                        # step: each dump is distinct forensics
                        path = os.path.join(d, f"{stem}-{n}.json")
                        n += 1
                tmp = f"{path}.tmp-{os.getpid()}"
                with open(tmp, "w") as f:
                    # sanitize first: bare NaN tokens are not RFC-8259
                    # JSON (jq and JSON.parse reject them)
                    json.dump(_finite(payload), f, default=_json_safe)
                os.replace(tmp, path)
                self.last_dump_path = path
                return path
            except Exception:
                return None

    def _dir(self, override: str | None = None) -> str:
        d = override or self.dump_dir or \
            os.environ.get("PADDLE_TPU_FLIGHT_DIR") or "."
        os.makedirs(d, exist_ok=True)
        return d

    def _payload(self, reason, step, extra, last) -> dict:
        payload = {
            "schema": SCHEMA_VERSION,
            "reason": reason,
            "step": step,
            "time": time.time(),
            "events": self.events(last),
            "fingerprint": _fingerprint(),
        }
        try:  # lazy: exporters is stdlib-only but keep dump failure-proof
            from ..exporters import snapshot
            payload["metrics"] = snapshot()
        except Exception:
            payload["metrics"] = None
        # request-tracer picture: open spans of in-flight requests and the
        # request-log tail, only if the tracer is loaded (a dying process
        # must never import new modules from the dump path)
        tracing_mod = sys.modules.get(
            __name__.rsplit(".", 1)[0] + ".tracing")
        if tracing_mod is not None:
            try:
                payload["tracing"] = tracing_mod.flight_snapshot()
            except Exception:
                payload["tracing"] = None
        if extra:
            payload["extra"] = extra
        return payload


def _json_safe(o):
    try:
        f = float(o)
        return f if f == f and f not in (float("inf"), float("-inf")) \
            else repr(f)
    except Exception:
        return repr(o)


def _finite(o):
    """Recursively replace non-finite floats with their repr strings so the
    dump is strict RFC-8259 JSON (json.dump would otherwise emit bare
    ``NaN``/``Infinity`` tokens)."""
    if isinstance(o, float):
        if o != o or o in (float("inf"), float("-inf")):
            return repr(o)
        return o
    if isinstance(o, dict):
        return {k: _finite(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_finite(v) for v in o]
    return o


def _fingerprint() -> dict:
    """Env/config fingerprint: enough to answer "what exactly was this
    process" from the dump alone, small enough to always include."""
    import platform
    keep = {}
    for k in sorted(os.environ):
        if k.startswith(("PADDLE_TPU_", "JAX_", "XLA_", "PALLAS_")):
            keep[k] = os.environ[k]
    out = {
        "argv": list(sys.argv),
        "pid": os.getpid(),
        "cwd": os.getcwd(),
        "python": platform.python_version(),
        "platform": platform.platform(),
        "env": keep,
    }
    return out


# ---------------------------------------------------------------------------
# process-wide default recorder + module-level API
# ---------------------------------------------------------------------------

_default = FlightRecorder()


def get_recorder() -> FlightRecorder:
    """The process-wide recorder all framework instrumentation feeds."""
    return _default


def record(kind: str, **fields) -> None:
    _default.record(kind, **fields)


def events(last: int | None = None) -> list:
    return _default.events(last)


def clear() -> None:
    _default.clear()


def enabled() -> bool:
    """True while the recorder collects events (``PADDLE_TPU_FLIGHT`` env,
    overridable via :func:`enable`). Hot call sites guard on this so a
    disabled recorder costs nothing — not even the kwargs dict."""
    return _default.enabled


def enable(flag: bool = True) -> bool:
    _default.enabled = bool(flag)
    return _default.enabled


def set_dump_dir(path: str) -> None:
    """Where abnormal-death dumps land (default ``PADDLE_TPU_FLIGHT_DIR``,
    else the working directory)."""
    _default.dump_dir = os.fspath(path)


def get_dump_dir() -> str | None:
    return _default.dump_dir


def dump(reason: str, step: int | None = None, path: str | None = None,
         extra: dict | None = None, last: int | None = None,
         dump_dir: str | None = None) -> str | None:
    return _default.dump(reason, step=step, path=path, extra=extra,
                         last=last, dump_dir=dump_dir)


def last_dump_path() -> str | None:
    return _default.last_dump_path


# ---------------------------------------------------------------------------
# dump reader + renderer (cold path)
# ---------------------------------------------------------------------------

def load_dump(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _fmt_event(e, t0) -> str:
    rest = {k: v for k, v in e.items() if k not in ("seq", "t", "kind")}
    body = " ".join(f"{k}={v}" for k, v in sorted(rest.items()))
    return f"  +{e.get('t', t0) - t0:10.3f}s  #{e.get('seq', '?'):>6}  " \
           f"{e.get('kind', '?'):<18} {body}"


def render(payload: dict, last: int = 25) -> str:
    """Human-readable view of a flight dump: the header, then the final
    events before death."""
    out = []
    evs = payload.get("events") or []
    t0 = evs[0]["t"] if evs else payload.get("time", 0.0)
    out.append("=" * 72)
    out.append(f"FLIGHT DUMP  reason={payload.get('reason')}  "
               f"step={payload.get('step')}  events={len(evs)}  "
               f"schema={payload.get('schema')}")
    fp = payload.get("fingerprint") or {}
    out.append(f"  argv: {' '.join(fp.get('argv', []))}")
    out.append("=" * 72)
    if evs and last > 0:
        out.append(f"\n-- final {min(last, len(evs))} events before death "
                   + "-" * 30)
        for e in evs[-last:]:
            out.append(_fmt_event(e, t0))
    out.append("=" * 72)
    return "\n".join(out)
