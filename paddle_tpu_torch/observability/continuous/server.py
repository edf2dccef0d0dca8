"""Live telemetry HTTP server (counterpart of
``paddle_tpu/observability/continuous/server.py``, the port's own copy):
the scrape surface the serving runtime mounts itself on.

Standard library ``http.server``, threaded and daemonic. Endpoints:

* ``GET /metrics``: the Prometheus text exposition
  (``observability.exporters.render_prometheus``), content type
  ``text/plain; version=0.0.4``.
* ``GET /healthz``: liveness as JSON. A registered health provider (the
  serving engine, ``serving.server.attach``) answers it; without one it
  is 200 ``{"status": "idle"}``.
* ``GET /flight``: the flight recorder's ring buffer as strict RFC-8259
  JSON (NaN stringified, the dump's sanitiser).
* ``GET /requests?last=N``: the request tracer's ring of completed
  requests plus the TTFT/TPOT histogram exemplars (bucket -> trace id).
* ``GET /trace/<trace_id>``: one request's span tree (completed
  reservoir or still in flight); 404 for an unknown id.
* ``POST`` (and other) routes that a runtime registers
  (:func:`register_route`; serving's ``POST /generate``).

``/profile`` and ``/dashboard`` belong to the continuous profiler and the
training health tier, which the port does not have yet: they answer 404.

Start with :func:`serve` (port from ``PADDLE_TPU_METRICS_PORT``; port 0
binds an ephemeral one). ``close()`` shuts a server down; the serving
engine's preemption calls :func:`shutdown_server` so a preempted process
leaves no acceptor thread behind.
"""

from __future__ import annotations

import json
import os
import threading
import warnings
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse


__all__ = ["TelemetryServer", "serve", "shutdown_server",
           "register_route", "unregister_route",
           "register_health_provider",
           "DEFAULT_PORT", "DEFAULT_STALL_S"]

DEFAULT_PORT = 9406
DEFAULT_STALL_S = 120.0


def _env_port() -> int:
    try:
        return int(os.environ.get("PADDLE_TPU_METRICS_PORT", DEFAULT_PORT))
    except ValueError:
        return DEFAULT_PORT


def _env_stall() -> float:
    try:
        return float(os.environ.get("PADDLE_TPU_HEALTH_STALL_S",
                                    DEFAULT_STALL_S))
    except ValueError:
        return DEFAULT_STALL_S


# -- extension points (the serving runtime mounts itself here) ---------------
#
# Routes: path -> fn(handler, method, query, body_bytes). The fn owns the
# whole response (handler._send / _send_json / raw writes for streaming).
# Health: provider(stall_after_s) -> (code, payload) | None; a non-None
# return replaces the idle payload: this is how /healthz learns serving
# mode (decode-step staleness) when an engine is attached, without the
# server knowing what serving is.

_EXTRA_ROUTES: dict = {}
_HEALTH_PROVIDER = None
# registration is copy-on-write under this lock: handler threads read
# _EXTRA_ROUTES bare (one atomic load of an immutable-once-published
# dict), so a serving runtime mounting itself mid-scrape can never make
# a handler iterate a dict that changes size under it
_ext_lock = threading.Lock()


def register_route(path: str, fn) -> None:
    """Mount ``fn(handler, method, query, body)`` at ``path`` on every
    (current and future) telemetry server in this process."""
    global _EXTRA_ROUTES
    with _ext_lock:
        routes = dict(_EXTRA_ROUTES)
        routes[path] = fn
        _EXTRA_ROUTES = routes


def unregister_route(path: str) -> None:
    global _EXTRA_ROUTES
    with _ext_lock:
        routes = dict(_EXTRA_ROUTES)
        routes.pop(path, None)
        _EXTRA_ROUTES = routes


def register_health_provider(fn) -> None:
    """Install (or clear, with None) the /healthz override provider."""
    global _HEALTH_PROVIDER
    with _ext_lock:
        _HEALTH_PROVIDER = fn


class _Handler(BaseHTTPRequestHandler):
    server_version = "paddle-tpu-telemetry/1"

    def log_message(self, *args):   # stdout silence: this runs inside
        pass                        # serving processes

    # -- plumbing ------------------------------------------------------------

    def _send(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, payload: dict):
        # same sanitizers as flight dumps: _finite stringifies NaN/Inf,
        # _json_safe catches non-native field values (np scalars, Paths)
        # recorded through flight.record's open **fields API
        from ..flight import _finite, _json_safe
        self._send(code, json.dumps(_finite(payload),
                                    default=_json_safe).encode(),
                   "application/json")

    # -- routes --------------------------------------------------------------

    def _dispatch(self, method: str, body: bytes | None):
        try:
            url = urlparse(self.path)
            routes_snapshot = _EXTRA_ROUTES   # one load; never mutated
            extra = routes_snapshot.get(url.path)
            if extra is not None:
                extra(self, method, parse_qs(url.query), body)
                return
            route = {"/metrics": self._metrics, "/healthz": self._healthz,
                     "/flight": self._flight,
                     "/requests": self._requests}.get(url.path)
            if route is None and url.path.startswith("/trace/"):
                if method != "GET":
                    self._send_json(405, {
                        "error": f"no {method} route {url.path!r}"})
                    return
                self._trace(url.path[len("/trace/"):], parse_qs(url.query))
                return
            if route is None or method != "GET":
                self._send_json(404 if route is None else 405, {
                    "error": f"no {method} route {url.path!r}",
                    "routes": sorted(["/metrics", "/healthz", "/flight",
                                      "/requests", "/trace/<trace_id>"] +
                                     list(routes_snapshot))})
                return
            route(parse_qs(url.query))
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception as e:  # a scrape must never kill the process
            try:
                self._send_json(500, {"error": repr(e)[:300]})
            except Exception:
                pass

    def do_GET(self):  # noqa: N802 (http.server contract)
        self._dispatch("GET", None)

    def do_POST(self):  # noqa: N802 (serving's /generate arrives here)
        try:
            # clamp below too: a negative Content-Length would turn
            # read() into read-until-EOF and pin this handler thread
            n = max(0, int(self.headers.get("Content-Length") or 0))
        except ValueError:
            n = 0
        body = self.rfile.read(min(n, 16 * 1024 * 1024)) if n else b""
        self._dispatch("POST", body)

    def _metrics(self, _q):
        from ..exporters import render_prometheus
        self._send(200, render_prometheus().encode(),
                   "text/plain; version=0.0.4; charset=utf-8")

    def _healthz(self, _q):
        stall = self.server.stall_after_s  # type: ignore[attr-defined]
        provider = _HEALTH_PROVIDER        # one load vs register races
        if provider is not None:
            override = provider(stall)
            if override is not None:
                code, payload = override
                self._send_json(code, payload)
                return
        self._send_json(200, {"status": "idle", "last_step": None,
                              "stall_after_s": stall})

    def _flight(self, _q):
        from .. import flight
        rec = flight.get_recorder()
        self._send_json(200, {"enabled": rec.enabled,
                              "capacity": rec.capacity,
                              "events": rec.events()})

    def _requests(self, q):
        """Recent completed requests: the tracer's request-log ring plus
        histogram exemplars (the trace-id join for TTFT/TPOT buckets)."""
        from .. import tracing
        try:
            last = int(q.get("last", ["50"])[0])
        except ValueError:
            self._send_json(400, {"error": "last must be an int"})
            return
        tr = tracing.get_tracer()
        self._send_json(200, {"enabled": tr.enabled,
                              "requests": tr.requests(last),
                              "exemplars": tr.exemplars(),
                              "stats": tr.stats()})

    def _trace(self, trace_id, _q):
        """Span tree of one trace (completed reservoir or in-flight)."""
        from .. import tracing
        snap = tracing.get_trace(trace_id)
        if snap is None:
            self._send_json(404, {"error": f"unknown trace id "
                                           f"{trace_id!r}"})
            return
        self._send_json(200, snap)


class TelemetryServer:
    """Threaded HTTP server over the process's telemetry. Construct via
    :func:`serve` (module-tracked, drain-aware) or directly for tests::

        srv = TelemetryServer(port=0).start()   # ephemeral port
        ...
        srv.close()                             # joins the acceptor thread
    """

    def __init__(self, port: int | None = None, host: str | None = None,
                 stall_after_s: float | None = None):
        port = _env_port() if port is None else int(port)
        if host is None:
            # scrape surfaces conventionally bind all interfaces, but the
            # endpoints are unauthenticated (/flight leaks run internals,
            # /generate runs the model) — PADDLE_TPU_METRICS_HOST=127.0.0.1
            # confines them to the host on untrusted networks
            host = os.environ.get("PADDLE_TPU_METRICS_HOST", "0.0.0.0")
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.stall_after_s = (  # type: ignore[attr-defined]
            _env_stall() if stall_after_s is None else float(stall_after_s))
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"paddle-tpu-telemetry:{self.port}", daemon=True)

    def start(self) -> "TelemetryServer":
        self._thread.start()
        return self

    @property
    def running(self) -> bool:
        return self._thread.is_alive()

    def close(self, timeout: float = 5.0) -> None:
        """Stop accepting, close the socket, join the acceptor thread —
        BOUNDED by ``timeout``, with a loud RuntimeWarning if the
        acceptor refuses to die (a wedged handler must not turn process
        shutdown into a hang). Idempotent; safe from any thread,
        including on a server that was constructed but never started
        (shutdown() would block forever waiting on an Event only
        serve_forever sets)."""
        try:
            if self._thread.is_alive():
                self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:
            pass
        if self._thread.is_alive():
            self._thread.join(timeout)
            if self._thread.is_alive():
                warnings.warn(
                    f"telemetry server acceptor thread "
                    f"{self._thread.name!r} did not exit within "
                    f"{timeout}s of close()", RuntimeWarning,
                    stacklevel=2)

    def __enter__(self) -> "TelemetryServer":
        return self if self.running else self.start()

    def __exit__(self, *exc):
        self.close()
        return False


_server: TelemetryServer | None = None
_server_lock = threading.Lock()


def serve(port: int | None = None, host: str | None = None,
          stall_after_s: float | None = None) -> TelemetryServer:
    """Start (or replace) the process-wide telemetry server and return it.
    ``port=None`` reads ``PADDLE_TPU_METRICS_PORT`` (default 9406);
    ``port=0`` binds an ephemeral port (``.port`` says which). The
    preemption drain shuts this server down via :func:`shutdown_server`."""
    global _server
    with _server_lock:
        if _server is not None:
            _server.close()
        _server = TelemetryServer(port=port, host=host,
                                  stall_after_s=stall_after_s).start()
        return _server


def shutdown_server(timeout: float = 5.0) -> bool:
    """Close the process-wide server if one is running (idempotent).
    Returns True when a server was actually shut down."""
    global _server
    with _server_lock:
        if _server is None:
            return False
        _server.close(timeout)
        _server = None
        return True
