"""HTTP front (counterpart of ``paddle_tpu/serving/server.py``):
``/generate`` mounted on the live telemetry server.

The serving runtime runs no HTTP stack of its own: it mounts onto the
telemetry server (``observability.serve``), which carries ``/metrics``
(with the ``paddle_tpu_serving_*`` series), ``/flight``, ``/requests``,
``/trace/<id>`` and ``/healthz``. :func:`attach` registers:

* ``POST /generate`` — body ``{"prompt_ids": [...], "max_new_tokens"?,
  "temperature"?, "stream"?}``. Non-streaming returns one JSON object
  with the generated tokens and timing; ``"stream": true`` returns
  newline-delimited JSON (``{"token": id}`` per token, then a final
  ``{"done": true, ...}`` record) as tokens are produced.
* a ``/healthz`` provider switching liveness to SERVING mode:
  decode-step staleness instead of train-step staleness, plus queue
  depth, batch occupancy inputs and tokens/s.

:func:`serve` is the one-call form: start (or reuse) the telemetry
server on a port and attach the engine.
"""

from __future__ import annotations

import json

from ..observability.continuous import server as _tserver
from .scheduler import RequestRejected, ServingError

__all__ = ["attach", "detach", "serve", "get_engine"]

_ENGINE = None


def get_engine():
    """The engine currently mounted on the HTTP surface (or None)."""
    return _ENGINE


def attach(engine) -> None:
    """Mount ``engine`` on the process's telemetry server: ``POST
    /generate`` plus the serving-mode ``/healthz`` provider. A second
    attach replaces the first (one serving engine per process)."""
    global _ENGINE
    _ENGINE = engine
    _tserver.register_route("/generate", _route_generate)
    _tserver.register_health_provider(_health_provider)


def detach() -> None:
    global _ENGINE
    _ENGINE = None
    _tserver.unregister_route("/generate")
    _tserver.register_health_provider(None)


def serve(engine, port: int | None = None, host: str | None = None):
    """Start the telemetry server (``observability.serve``) and mount the
    engine. Returns the :class:`TelemetryServer` (``.port`` tells which
    port an ephemeral ``port=0`` bind chose)."""
    from ..observability import serve as obs_serve
    attach(engine)
    return obs_serve(port=port, host=host)


def _health_provider(stall_after_s):
    eng = _ENGINE
    if eng is None:
        return None
    return eng.health(stall_after_s)


def _route_generate(handler, method, query, body):
    if method != "POST":
        handler._send_json(405, {"error": "POST a JSON body to /generate"})
        return
    eng = _ENGINE
    if eng is None:
        handler._send_json(503, {"error": "no serving engine attached"})
        return
    try:
        payload = json.loads(body or b"{}")
    except ValueError as e:
        handler._send_json(400, {"error": f"invalid JSON body: {e}"})
        return
    prompt = payload.get("prompt_ids")
    if not isinstance(prompt, list) or not prompt or \
            not all(isinstance(t, int) for t in prompt):
        handler._send_json(400, {"error": "prompt_ids must be a non-empty "
                                          "list of token ids"})
        return
    kw = {}
    if payload.get("max_new_tokens") is not None:
        kw["max_new_tokens"] = int(payload["max_new_tokens"])
    if payload.get("temperature") is not None:
        kw["temperature"] = float(payload["temperature"])
    if payload.get("eos_token_id") is not None:
        kw["eos_token_id"] = int(payload["eos_token_id"])
    # inbound W3C trace context: header wins, body field as fallback;
    # malformed values degrade to a fresh trace (never a 4xx)
    tp = None
    try:
        tp = handler.headers.get("traceparent")
    except Exception:
        tp = None
    if not tp:
        tp = payload.get("traceparent")
    if tp is not None:
        kw["traceparent"] = str(tp)
    timeout = float(payload.get("timeout_s") or 300.0)
    try:
        req = eng.submit(prompt, **kw)
    except RequestRejected as e:
        # capacity/admission rejection: the client must shrink or retry
        # elsewhere, not wait
        handler._send_json(429, {"error": str(e)})
        return
    except (ValueError, ServingError) as e:
        handler._send_json(400, {"error": str(e)})
        return

    if not payload.get("stream"):
        try:
            toks = req.result(timeout=timeout)
        except TimeoutError as e:
            handler._send_json(504, {"error": str(e)})
            return
        except ServingError as e:
            handler._send_json(500, {"error": str(e),
                                     "request_id": req.request_id})
            return
        handler._send_json(200, _summary(req, toks))
        return

    # newline-delimited JSON stream, one record per token
    handler.send_response(200)
    handler.send_header("Content-Type", "application/x-ndjson")
    handler.send_header("Cache-Control", "no-store")
    handler.end_headers()
    import queue as _queue
    try:
        while True:
            try:
                kind, val = req.events.get(timeout=timeout)
            except _queue.Empty:
                # a mid-stream stall must end the body with a terminal
                # ndjson record — never escape into the dispatcher, which
                # would write a second HTTP status line into this body
                handler.wfile.write(json.dumps(
                    {"error": f"no token within {timeout}s",
                     "request_id": req.request_id}).encode() + b"\n")
                return
            if kind == "token":
                handler.wfile.write(
                    json.dumps({"token": int(val)}).encode() + b"\n")
                handler.wfile.flush()
            elif kind == "done":
                handler.wfile.write(json.dumps(
                    dict(_summary(req, list(req.tokens)),
                         done=True)).encode() + b"\n")
                return
            else:
                handler.wfile.write(json.dumps(
                    {"error": val, "request_id": req.request_id}
                ).encode() + b"\n")
                return
    except (BrokenPipeError, ConnectionResetError):
        return  # client went away; the request itself keeps running


def _summary(req, toks) -> dict:
    return {
        "request_id": req.request_id,
        "trace_id": req.trace.trace_id,
        "tokens": [int(t) for t in toks],
        "num_generated": len(toks),
        "ttft_ms": round(req.ttft_ms, 3) if req.ttft_ms is not None else None,
        "e2e_ms": round(req.e2e_ms, 3) if req.e2e_ms is not None else None,
        # TTFT attribution split (queue wait vs prefill vs decode)
        "queue_ms": round(req.queue_ms, 3),
        "prefill_ms": round(req.prefill_ms, 3),
        "decode_ms": round(req.decode_ms, 3)
        if req.decode_ms is not None else None,
        "state": req.state,
    }
