"""paddle_tpu_torch's serving HTTP front against the JAX package's tests, on
the CPU: the four HTTP tests of the JAX package (``tests/test_serving.py``),
their assertions against the port's ``serving.server`` on a
``llama_tiny`` carried across with ``llama_from_jax_state``; the telemetry
server's close / idempotence / scrape-error assertions
(``tests/test_telemetry_server.py``) against the port's server; the
engine's SIGTERM preemption (drain, flight dump with the open spans, the
server shut down); ``/requests`` and ``/trace/<id>``; and the off switches.
``test_torch_serving_observability.py`` holds the scripted run against the
JAX engine and shares this file's model fixture.
"""

import dataclasses
import json
import os
import signal
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
import paddle_tpu_torch.observability as tobs
from paddle_tpu_torch.models import LlamaConfig, llama_from_jax_state
from paddle_tpu_torch.observability import flight as tflight
from paddle_tpu_torch.observability import tracing as ttracing
from paddle_tpu_torch.observability.continuous import TelemetryServer
from paddle_tpu_torch.serving import LLMEngine, ServingConfig
from paddle_tpu_torch.serving import server as sserver

from test_prometheus_format import validate_exposition

ENGINE = dict(page_size=8, num_pages=17, max_batch=2, max_new_tokens=6)
SHARED = [7, 3, 9, 1, 4, 8, 2, 6, 5, 11, 12, 13, 14, 15, 16, 17]
# one prefill bucket (32) and one chunk bucket (8): the JAX engine
# compiles three programs
SCRIPT = [SHARED + [21, 22, 23], SHARED + [31, 32],
          [50 + i for i in range(20)], SHARED + [41]]


def _serving_metrics(reg):
    return {m.name: m for m in reg.metrics()
            if m.name.startswith("paddle_tpu_serving_")}


@pytest.fixture(scope="module")
def models():
    paddle.seed(11)
    jm = jax_llama_tiny()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    cfg = LlamaConfig(**dataclasses.asdict(jm.cfg))
    return jm, llama_from_jax_state(state, cfg, device="cpu")


def test_off_switches_leave_no_trace(models):
    _, tm = models
    tobs.reset()
    tflight.clear()
    ttracing.reset()
    tobs.enable(False)
    tflight.enable(False)
    ttracing.enable(False)
    try:
        eng = LLMEngine(tm, ServingConfig(**ENGINE), device="cpu")
        req = eng.submit([1, 2, 3], max_new_tokens=3)
        assert len(req.result(timeout=120)) == 3
        assert req.trace is ttracing.NOOP_TRACE
        assert req.ttft_ms is not None and req.queue_ms >= 0
        eng.shutdown()
    finally:
        tobs.enable(True)
        tflight.enable(True)
        ttracing.enable(True)
    assert not _serving_metrics(tobs.get_registry()) or not any(
        m.series() for m in _serving_metrics(tobs.get_registry()).values())
    assert tflight.events() == [] and ttracing.requests() == []


# -- the JAX package's HTTP tests, against the port ---------------------------------

@pytest.fixture
def http_engine(models):
    _, tm = models
    eng = LLMEngine(tm, ServingConfig(**dict(ENGINE, max_new_tokens=4)),
                    device="cpu")
    srv = sserver.serve(eng, port=0, host="127.0.0.1")
    yield eng, srv.port
    srv.close()
    sserver.detach()
    eng.shutdown()


def _post(port, path, payload, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _get(port, path):
    """(status, headers, body bytes); 4xx / 5xx returned, not raised."""
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def test_http_generate_roundtrip(http_engine):
    eng, port = http_engine
    r = _post(port, "/generate", {"prompt_ids": [1, 2, 3],
                                  "max_new_tokens": 3})
    body = json.loads(r.read())
    assert r.status == 200
    assert len(body["tokens"]) == 3
    assert body["state"] == "completed"
    assert body["ttft_ms"] is not None and body["e2e_ms"] is not None
    assert body["tokens"] == eng.generate([1, 2, 3], max_new_tokens=3)


def test_http_generate_streams_ndjson(http_engine):
    eng, port = http_engine
    r = _post(port, "/generate", {"prompt_ids": [4, 5], "stream": True,
                                  "max_new_tokens": 3})
    lines = [json.loads(line) for line in r.read().splitlines()]
    assert [line["token"] for line in lines[:-1]] == lines[-1]["tokens"]
    assert lines[-1]["done"] is True


def test_http_generate_validates_and_rejects(http_engine):
    eng, port = http_engine
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, "/generate", {"prompt_ids": "nope"})
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, "/generate", {"prompt_ids": [1] * 200,
                                  "max_new_tokens": 50})
    assert e.value.code == 429        # admission rejection -> back off
    status, _, body = _get(port, "/generate")
    assert status == 405 and "POST" in json.loads(body)["error"]


def test_http_healthz_serving_mode_and_metrics(http_engine):
    eng, port = http_engine
    _post(port, "/generate", {"prompt_ids": [1, 2], "max_new_tokens": 2})
    h = json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{port}/healthz", timeout=30).read())
    assert h["mode"] == "serving"
    assert h["status"] in ("idle", "ok")
    assert h["decode_steps"] >= 1
    text = urllib.request.urlopen(
        f"http://127.0.0.1:{port}/metrics", timeout=30).read().decode()
    metrics = validate_exposition(text)       # grammar-valid exposition
    serving = [m for m in metrics if m.startswith("paddle_tpu_serving_")]
    assert "paddle_tpu_serving_decode_steps_total" in serving
    assert "paddle_tpu_serving_ttft_ms" in serving
    assert "paddle_tpu_serving_kv_pages" in serving


def test_http_requests_trace_and_flight(http_engine):
    eng, port = http_engine
    ttracing.reset()
    tp = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps({"prompt_ids": [3, 4, 5], "max_new_tokens": 2})
        .encode(), headers={"traceparent": tp})
    body = json.loads(urllib.request.urlopen(req, timeout=120).read())
    assert body["trace_id"] == "ab" * 16        # the inbound context joined
    status, _, raw = _get(port, "/requests?last=5")
    recs = json.loads(raw)
    assert status == 200 and len(recs["requests"]) == 1
    assert "paddle_tpu_serving_ttft_ms" in recs["exemplars"]
    assert set(recs["requests"][0]["span_kinds"]) >= {
        "queue_wait", "admit", "prefill", "decode", "stream"}
    status, _, raw = _get(port, f"/trace/{body['trace_id']}")
    assert status == 200 and json.loads(raw)["root"]["parent_id"] == "cd" * 8
    assert _get(port, "/trace/" + "0" * 32)[0] == 404
    assert _get(port, "/requests?last=x")[0] == 400
    status, _, raw = _get(port, "/flight")
    kinds = [e["kind"] for e in json.loads(raw)["events"]]
    assert {"serving_submit", "serving_prefill", "serving_complete"} <= \
        set(kinds)
    for path in ("/profile", "/dashboard"):
        assert _get(port, path)[0] == 404


# -- the telemetry server's lifecycle ------------------------------------------------

def test_healthz_idle_without_provider_and_scrape_error(monkeypatch):
    srv = TelemetryServer(port=0, host="127.0.0.1").start()
    try:
        status, _, body = _get(srv.port, "/healthz")
        assert status == 200 and json.loads(body)["status"] == "idle"
        import paddle_tpu_torch.observability.exporters as exporters
        monkeypatch.setattr(exporters, "render_prometheus",
                            lambda *a, **k: 1 / 0)
        status, _, body = _get(srv.port, "/metrics")
        assert status == 500 and "ZeroDivisionError" in \
            json.loads(body)["error"]
        assert _get(srv.port, "/healthz")[0] == 200     # still alive
    finally:
        srv.close()


def test_close_before_start_does_not_hang():
    srv = TelemetryServer(port=0, host="127.0.0.1")
    srv.close(timeout=1.0)   # never started: must return, not block
    assert not srv.running


def test_close_joins_acceptor_thread():
    srv = TelemetryServer(port=0, host="127.0.0.1").start()
    port = srv.port
    assert srv.running
    srv.close()
    assert not srv.running
    assert not any(t.name == f"paddle-tpu-telemetry:{port}"
                   for t in threading.enumerate())
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                               timeout=2)


def test_serve_replaces_and_shutdown_is_idempotent():
    s1 = tobs.serve(0, host="127.0.0.1")
    p1 = s1.port
    s2 = tobs.serve(0, host="127.0.0.1")   # replaces s1
    try:
        assert not s1.running and s2.running and s2.port != p1
    finally:
        assert tobs.shutdown_server() is True
    assert tobs.shutdown_server() is False  # idempotent
    assert not s2.running


def test_preemption_drains_dumps_and_shuts_the_server(models, tmp_path,
                                                      monkeypatch):
    """SIGTERM: the request in flight finishes, the flight dump carries
    reason ``serving_preempted`` and the spans open at the signal, the
    telemetry server is shut down, and the process exits 143."""
    _, tm = models
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path))
    eng = LLMEngine(tm, ServingConfig(**dict(ENGINE, max_new_tokens=40)),
                    device="cpu")
    srv = sserver.serve(eng, port=0, host="127.0.0.1")
    eng.install_preemption()
    try:
        req = eng.submit([1, 2, 3, 4])
        deadline = time.monotonic() + 60
        while not req.tokens and time.monotonic() < deadline:
            time.sleep(0.01)
        with pytest.raises(SystemExit) as e:
            os.kill(os.getpid(), signal.SIGTERM)
            time.sleep(60)
        assert e.value.code == 143
    finally:
        eng.uninstall_preemption()
        sserver.detach()
    assert req.state == "completed" and len(req.tokens) == 40
    assert not srv.running
    assert not any(t.name.startswith("paddle-tpu-telemetry")
                   for t in threading.enumerate())
    dump = tflight.load_dump(tflight.last_dump_path())
    assert dump["reason"] == "serving_preempted"
    assert os.path.dirname(tflight.last_dump_path()) == str(tmp_path)
    opened = dump["extra"]["tracing_at_preempt"]["open_spans"]
    assert any(s["request_id"] == req.request_id for s in opened)
    kinds = [e["kind"] for e in dump["events"]]
    assert "serving_preempt" in kinds and "serving_drain" in kinds
    assert dump["extra"]["serving"]["completed"] >= 1
    assert "FLIGHT DUMP  reason=serving_preempted" in tflight.render(dump)
    assert signal.getsignal(signal.SIGTERM) is not None


def test_registry_counts_every_update_under_threads():
    """The engine thread writes the series while server threads read them:
    16 threads (more than the cores) at a shortened switch interval lose
    no counter increment and no histogram observation."""
    import sys
    c = tobs.counter("paddle_tpu_test_stress_total", "stress")
    h = tobs.histogram("paddle_tpu_test_stress_ms", "stress",
                       buckets=(1.0, 10.0))
    c.clear()
    h.clear()

    def work():
        for i in range(2000):
            c.inc(kind="a")
            h.observe(i % 20)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert c.value(kind="a") == 32000
    assert h.value()["count"] == 32000
    assert h.value()["buckets"]["+Inf"] == 32000
