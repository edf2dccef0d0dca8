"""paddle_tpu_torch's serving observability against the JAX package's, on the
CPU (beside ``test_torch_serving_http.py``, whose model fixture it shares):
the same scripted requests go through the JAX and the port ``LLMEngine``
on one ``llama_tiny``, each scheduler stepped on the test thread so the
order of events is fixed. Held equal, exactly: the ``paddle_tpu_serving_*``
series (names, types, help texts, label sets, histogram buckets), the
request, token, prefill, decode-step, prefix and page counts, the flight
events' kinds in order, each request's span kinds, and the generated
tokens.
"""


import torch

import paddle_tpu.observability as jobs
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import ServingConfig as JaxConfig
from paddle_tpu.serving.scheduler import Request as JaxRequest
import paddle_tpu_torch.observability as tobs
from paddle_tpu_torch.observability import flight as tflight
from paddle_tpu_torch.observability import tracing as ttracing
from paddle_tpu_torch.serving import LLMEngine, ServingConfig
from paddle_tpu_torch.serving.scheduler import Request

from test_torch_serving_http import (  # noqa: F401 — shared helpers
    ENGINE, SCRIPT, _serving_metrics, models)


def _drive(sched, reqs):
    for r in reqs:
        sched.submit(r)
    while sched.has_work():
        sched.step()


def test_scripted_run_gives_the_jax_series_events_and_spans(models):
    jm, tm = models
    jobs.reset()
    tobs.reset()
    jobs.flight.clear()
    tflight.clear()
    jeng = JaxEngine(jm, JaxConfig(**ENGINE))
    teng = LLMEngine(tm, ServingConfig(**ENGINE), device="cpu")
    jreqs = [JaxRequest(p, 4) for p in SCRIPT]
    treqs = [Request(p, 4) for p in SCRIPT]
    _drive(jeng.scheduler, jreqs)
    with torch.inference_mode():
        _drive(teng.scheduler, treqs)
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    assert all(r.state == "completed" for r in treqs)

    jm_, tm_ = (_serving_metrics(jobs.get_registry()),
                _serving_metrics(tobs.get_registry()))
    assert sorted(tm_) == sorted(jm_)
    for name, j in jm_.items():
        t = tm_[name]
        assert (t.kind, t.help) == (j.kind, j.help), name
        if j.kind == "histogram":
            assert t.buckets == j.buckets, name
        assert [lab for lab, _ in t.series()] == \
            [lab for lab, _ in j.series()], name
    for name in ("paddle_tpu_serving_requests_total",
                 "paddle_tpu_serving_submissions_total",
                 "paddle_tpu_serving_tokens_total",
                 "paddle_tpu_serving_prefills_total",
                 "paddle_tpu_serving_decode_steps_total",
                 "paddle_tpu_serving_kv_pages",
                 "paddle_tpu_serving_shared_pages",
                 "paddle_tpu_serving_prefix_hits_total",
                 "paddle_tpu_serving_prefix_misses_total",
                 "paddle_tpu_serving_prefix_entries",
                 "paddle_tpu_serving_cow_copies_total",
                 "paddle_tpu_serving_queue_depth",
                 "paddle_tpu_serving_active_requests",
                 "paddle_tpu_serving_batch_occupancy"):
        assert tm_[name].series() == jm_[name].series(), name
    for name in ("paddle_tpu_serving_ttft_ms", "paddle_tpu_serving_e2e_ms",
                 "paddle_tpu_serving_tpot_ms",
                 "paddle_tpu_serving_queue_wait_ms"):
        assert tm_[name].value()["count"] == jm_[name].value()["count"]
    assert tm_["paddle_tpu_serving_tokens_total"].value(kind="generated") \
        == sum(len(r.tokens) for r in treqs)
    assert tm_["paddle_tpu_serving_prefix_hits_total"].value() > 0

    jkinds = [e["kind"] for e in jobs.flight.events()
              if e["kind"].startswith("serving_")]
    tkinds = [e["kind"] for e in tflight.events()]
    assert tkinds == jkinds
    assert {"serving_submit", "serving_prefix_hit", "serving_prefill",
            "serving_decode", "serving_complete"} <= set(tkinds)
    for jr, tr in zip(jreqs, treqs):
        jrec = jobs.tracing.get_trace(jr.trace.trace_id)["record"]
        trec = ttracing.get_trace(tr.trace.trace_id)["record"]
        assert trec["span_kinds"] == jrec["span_kinds"]
        assert (trec["spans"], trec["generated"], trec.get("cached_tokens")) \
            == (jrec["spans"], jrec["generated"], jrec.get("cached_tokens"))
    stats = teng.stats()
    assert set(stats) == set(jeng.stats()) - {"programs"} | \
        {"tokens_per_step"}
    code, health = teng.health()
    jcode, jhealth = jeng.health()
    assert code == jcode == 200 and set(health) == set(jhealth)
    assert set(health["timing_split"]) == set(jhealth["timing_split"])
    assert health["status"] == "idle" and health["mode"] == "serving"
    jeng.shutdown()
    teng.shutdown()


def test_hooks_off_record_nothing_and_turns_time_the_scheduler(models):
    """``chip_smoke._serve_turn`` (the on / off finding of the http phase):
    with metrics, tracing and the flight recorder off the engine records
    no series, span or event; on, the generated-token counter moves by the
    tokens returned; every turn times the scheduler's iterations, whose
    host work outside the forward spans is part of their wall; the three
    switches are on again after either turn."""
    import chip_smoke

    _, tm = models
    tobs.reset()
    tflight.clear()
    ttracing.reset()
    teng = LLMEngine(tm, ServingConfig(**ENGINE), device="cpu")
    try:
        off = chip_smoke._serve_turn(teng, SCRIPT, 3, hooks=False)
        assert tobs.total("paddle_tpu_serving_tokens_total") == 0
        assert tflight.events() == [] and ttracing.requests() == []
        on = chip_smoke._serve_turn(teng, SCRIPT, 3, hooks=True)
        assert tobs.value("paddle_tpu_serving_tokens_total",
                          kind="generated") == 3 * len(SCRIPT)
        assert len(ttracing.requests()) == len(SCRIPT)
    finally:
        teng.shutdown()
    assert tobs.enabled() and tflight.enabled() and \
        ttracing.tracing_enabled()
    for turn, mode in ((off, "off"), (on, "on")):
        assert turn["hooks"] == mode and turn["tokens"] == 3 * len(SCRIPT)
        assert turn["iterations"] >= turn["decode_steps"] > 0
        assert 0 <= turn["host_ms_per_iter"] <= turn["iter_ms_mean"]
    assert set(chip_smoke._turn_medians([off, on])) == {"off", "on"}
