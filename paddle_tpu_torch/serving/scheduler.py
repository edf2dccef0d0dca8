"""Iteration-level (continuous-batching) scheduler over the paged pool
(counterpart of ``paddle_tpu/serving/scheduler.py``).

Policy only, no device code. Each :meth:`Scheduler.step` is one engine
iteration:

1. **Admission** (FIFO): while a decode slot is free, seat the oldest
   waiting request if the pool can hold its context plus one page of
   headroom (for its first decode write). With a prefix cache, the
   longest cached page-aligned prefix of its context is claimed first and
   needs no prefill; a full cover is capped at ``len(context) - 1`` tokens,
   because the last token's logits seed generation. The oldest request is
   never overtaken, so admission cannot starve. With monolithic prefill
   (``prefill_chunk=None``) the admitted request is prefilled at once
   (a prefix hit runs only the suffix, as one chunk) and samples its first
   token.
2. **Chunked prefill** (``prefill_chunk`` set): seated requests not yet
   prefilled advance by fixed-size chunks, oldest first, at most one
   chunk's worth of tokens per iteration, so a long prompt never stalls
   the decodes in flight; the final chunk samples the first token.
3. **Growth**: every active request whose next write crosses a page
   boundary takes a page. When the pool is exhausted the **youngest**
   active request is evicted: its page references are dropped (a page
   another request shares stays live for it) and it is requeued in
   arrival order with its generated tokens kept.
4. **Decode**: one batched step over every prefill-complete slot (the
   other slots ride along at position 0 on the trash page). Finished
   requests (eos, ``max_new_tokens`` or the length limit) drop their pages.
   With speculative decoding (``spec_k`` K > 0) the drafter first proposes
   up to K tokens a request from its own history; when any request
   drafted, the step runs the engine's verify over K + 1 lanes a row
   instead (rows without drafts ride along at ``draft_len`` 0 and advance
   one token), emits each row's accepted tokens as one burst and rolls
   back the pages that held only rejected drafts. Every row's plain-decode
   page comes first; a draft span that finds no free page is dropped and
   never evicts another request. Per-request adaptive K
   (:class:`~.speculative.SpecState`) takes an unpredictable stream back
   to plain decode.

Before any KV write lands in a page shared with another request (refcount
>= 2), :meth:`Scheduler._make_writable` copies the page and remaps it
(copy-on-write). A request that can never fit (length over the limit, or
more pages than the pool holds) is rejected at :meth:`Scheduler.submit`.

Chunked prefill spends at most ``prefill_budget`` tokens an iteration
(default: one chunk).

Observability, as the JAX scheduler's: the ``paddle_tpu_serving_*``
series (requests, tokens, decode steps, prefills, evictions, copy-on-write
copies, queue depth, occupancy, the TTFT / TPOT / e2e / queue-wait
histograms, the speculative counters), a request trace a request (spans
``queue_wait``, ``admit``, ``prefill`` or ``prefill_chunk``, ``decode`` and
``speculate`` bursts, ``evict``, ``cow``, ``stream``) and the
``serving_*`` flight events. With metrics, tracing and the flight recorder
off, each hook costs one branch.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
import uuid

import numpy as np

from ..observability import flight as _flight
from ..observability import metrics as _metrics
from ..observability import tracing as _tracing
from .kv_cache import PagePoolExhausted
from .speculative import NgramDrafter, SpecState

__all__ = ["Request", "Scheduler", "RequestRejected", "ServingError",
           "QUEUED", "RUNNING", "COMPLETED", "FAILED", "REJECTED",
           "CANCELLED"]

QUEUED = "queued"
RUNNING = "running"
COMPLETED = "completed"
FAILED = "failed"
REJECTED = "rejected"
CANCELLED = "cancelled"

_TERMINAL = (COMPLETED, FAILED, REJECTED, CANCELLED)

_NOOP = _tracing.NOOP_TRACE
_REC = _flight.get_recorder()      # hooks test ``_REC.enabled``: one branch
_MON = _metrics._state             # ``_MON.enabled``: the metrics switch

_MS_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
               1000.0, 2500.0, 5000.0, 10000.0, 30000.0)

_REQS = _metrics.counter("paddle_tpu_serving_requests_total",
                         "serving requests by terminal status")
_SUBMITS = _metrics.counter("paddle_tpu_serving_submissions_total",
                            "requests submitted to the engine")
_TOKENS = _metrics.counter("paddle_tpu_serving_tokens_total",
                           "tokens processed (kind=prompt|generated)",
                           windowed=True)
_STEPS = _metrics.counter("paddle_tpu_serving_decode_steps_total",
                          "batched decode steps executed", windowed=True)
_PREFILLS = _metrics.counter("paddle_tpu_serving_prefills_total",
                             "prefill program runs by compile bucket")
_EVICTIONS = _metrics.counter("paddle_tpu_serving_evictions_total",
                              "requests evicted (pages reclaimed, requeued)")
_COW = _metrics.counter("paddle_tpu_serving_cow_copies_total",
                        "copy-on-write page copies (a write was about to "
                        "land in a shared page)")
_QUEUE = _metrics.gauge("paddle_tpu_serving_queue_depth",
                        "requests waiting for admission")
_ACTIVE = _metrics.gauge("paddle_tpu_serving_active_requests",
                         "requests holding a decode slot")
_OCC = _metrics.gauge("paddle_tpu_serving_batch_occupancy",
                      "active decode slots / max_batch")
_TTFT = _metrics.histogram("paddle_tpu_serving_ttft_ms",
                           "submit -> first token (ms)", buckets=_MS_BUCKETS)
_TPOT = _metrics.histogram("paddle_tpu_serving_tpot_ms",
                           "inter-token latency after the first (ms; a "
                           "multi-token speculative burst amortizes the "
                           "step gap over its tokens)",
                           buckets=_MS_BUCKETS)
_E2E = _metrics.histogram("paddle_tpu_serving_e2e_ms",
                          "submit -> completion (ms)", buckets=_MS_BUCKETS)
_QUEUE_WAIT = _metrics.histogram(
    "paddle_tpu_serving_queue_wait_ms",
    "enqueue -> admission wait (ms; a re-admission after eviction "
    "counts each wait segment) — the scheduler-delay share of TTFT",
    buckets=_MS_BUCKETS)
_SPEC_PROPOSED = _metrics.counter(
    "paddle_tpu_serving_spec_proposed_tokens_total",
    "draft tokens proposed to the verify program", windowed=True)
_SPEC_ACCEPTED = _metrics.counter(
    "paddle_tpu_serving_spec_accepted_tokens_total",
    "draft tokens accepted by verification", windowed=True)
_SPEC_REJECTED = _metrics.counter(
    "paddle_tpu_serving_spec_rejected_tokens_total",
    "draft tokens rejected by verification (KV rolled back)")
_SPEC_RATE = _metrics.gauge(
    "paddle_tpu_serving_spec_acceptance_rate",
    "windowed draft acceptance rate (accepted/proposed over the last "
    "60s of verify steps)")
_SPEC_K = _metrics.gauge(
    "paddle_tpu_serving_spec_k",
    "current adaptive draft length K by decode slot")

_arrival = itertools.count()


class ServingError(RuntimeError):
    """A request failed inside the engine (carried on Request.error)."""


class RequestRejected(ServingError):
    """Admission control: the request can never fit (prompt + max_new
    exceeds the pool or the length limit)."""


class Request:
    """One generation request and its runtime state (engine-owned; user
    code holds it as a handle: ``result()``, ``events``, timing fields)."""

    def __init__(self, prompt, max_new_tokens, temperature=0.0,
                 eos_token_id=None, request_id=None, on_token=None,
                 traceparent=None):
        self.prompt = [int(t) for t in prompt]
        if not self.prompt:
            raise ValueError("empty prompt")
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.temperature = float(temperature)
        self.eos_token_id = eos_token_id
        self.request_id = request_id or uuid.uuid4().hex[:12]
        self.on_token = on_token
        self.state = QUEUED
        self.tokens: list[int] = []
        self.error: str | None = None
        self.pages: list[int] = []
        self.slot: int | None = None
        self.arrival = next(_arrival)
        self.evictions = 0
        # adaptive draft length, made at admission when the engine
        # speculates; kept across an eviction with its acceptance EWMA
        self.spec: SpecState | None = None
        # context tokens whose KV is resident (prefix-cache hits count;
        # chunked prefill advances it chunk by chunk)
        self.prefilled = 0
        self._prefill_target = 0     # context length at admission
        self._cached_tokens = 0      # prefix-cache hit size at admission
        self._chain_keys: list = []  # prefix-cache chain keys of that ctx
        self._pending_keys: list = []    # keys memoized while blocked
        self._pending_keys_len = -1
        self.events: queue.Queue = queue.Queue()
        self._done = threading.Event()
        # timing (monotonic seconds; ms aggregates computed at finish)
        self.t_submit = time.monotonic()
        self.t_first_token: float | None = None
        self.t_done: float | None = None
        self._t_last = None
        self.ttft_ms: float | None = None      # submit -> first token
        self.e2e_ms: float | None = None       # submit -> finished
        self.tpot_ms: list[float] = []
        # lifecycle split (queue wait, prefill compute, decode wall),
        # tracked with tracing on or off: the request log and the HTTP
        # summary carry it
        self.queue_ms = 0.0
        self.prefill_ms = 0.0
        self.decode_ms: float | None = None
        self._t_enqueued = self.t_submit
        self._t_enqueued_wall = time.time()
        # the request trace: NOOP_TRACE when tracing is off (hot paths
        # check identity before building span attributes)
        self.trace = _tracing.start_request(
            request_id=self.request_id, traceparent=traceparent,
            prompt_tokens=len(self.prompt),
            max_new_tokens=self.max_new_tokens)
        self._tr_burst: dict | None = None   # engine-thread-owned
        self._stream_span = None

    # -- engine side ---------------------------------------------------------

    def context(self) -> list[int]:
        """Token ids whose KV must be resident: prompt + generated so far
        (prefilled again wholesale after an eviction)."""
        return self.prompt + self.tokens

    def context_tail(self, n: int) -> list[int]:
        """The last ``n`` context tokens, without building the whole
        context: the drafter's lookback stays O(window)."""
        n = int(n)
        if n <= 0:
            return []
        if len(self.tokens) >= n:
            return self.tokens[-n:]
        return self.prompt[-(n - len(self.tokens)):] + self.tokens

    def cur_len(self) -> int:
        return len(self.prompt) + len(self.tokens)

    @property
    def prefill_done(self) -> bool:
        """True once the admission context is resident and the first token
        sampled: only then may decode pick the slot up."""
        return self._prefill_target > 0 and \
            self.prefilled >= self._prefill_target

    def _emit(self, token: int) -> None:
        self._emit_burst([token])

    def _emit_burst(self, toks) -> None:
        """Emit one step's generated tokens: one for a decode step, up to
        K + 1 for a verify step. Latency counts tokens, not steps: the gap
        since the previous emission is spread over the burst's tokens
        (TPOT, time per output token)."""
        toks = [int(t) for t in toks]
        if not toks:
            return
        now = time.monotonic()
        if self.t_first_token is None:
            self.t_first_token = now
            self.ttft_ms = (now - self.t_submit) * 1000.0
            _TTFT.observe(self.ttft_ms)
            if self.trace is not _NOOP:
                # stream-emission span: first delivered token -> finish
                self._stream_span = self.trace.span("stream")
            self.tokens.append(toks[0])
            self._deliver(toks[0])
            self._t_last = now
            rest = toks[1:]
        else:
            rest = toks
        if rest:
            gap = (now - self._t_last) * 1000.0 / len(rest)
            for t in rest:
                self.tokens.append(t)
                self.tpot_ms.append(gap)
                _TPOT.observe(gap)
                self._deliver(t)
        self._t_last = now

    def _deliver(self, token: int) -> None:
        self.events.put(("token", token))
        if self.on_token is not None:
            try:
                self.on_token(token)
            except Exception:   # noqa: BLE001 — a user callback must
                pass            # never kill the engine loop

    def _trace_step(self, kind: str, t_start: float, tokens: int = 1,
                    **extra) -> None:
        """Fold one decode or verify iteration into the current span
        burst: consecutive steps of one kind make ONE span until the kind
        changes or the burst cap (``PADDLE_TPU_TRACE_BURST``) is reached;
        numeric extras sum over the burst. Engine-thread-owned."""
        if self.trace is _NOOP:
            return
        b = self._tr_burst
        if b is not None and b["kind"] != kind:
            self._trace_flush()
            b = None
        if b is None:
            b = self._tr_burst = {"kind": kind, "t0": t_start,
                                  "steps": 0, "tokens": 0, "extra": {}}
        b["steps"] += 1
        b["tokens"] += tokens
        for k, v in extra.items():
            b["extra"][k] = b["extra"].get(k, 0) + v
        if b["steps"] >= _tracing.decode_burst():
            self._trace_flush()

    def _trace_flush(self) -> None:
        b = self._tr_burst
        if b is None:
            return
        self._tr_burst = None
        self.trace.add_span(b["kind"], t_start=b["t0"], t_end=time.time(),
                            steps=b["steps"], tokens=b["tokens"],
                            **b["extra"])

    def _finish(self, state: str, error: str | None = None) -> None:
        if self.state in _TERMINAL:
            return
        self.state = state
        self.error = error
        self.t_done = time.monotonic()
        self.e2e_ms = (self.t_done - self.t_submit) * 1000.0
        if self.t_first_token is not None:
            self.decode_ms = (self.t_done - self.t_first_token) * 1000.0
        _REQS.inc(status=state)
        if state == COMPLETED:
            _E2E.observe(self.e2e_ms)
        if self.trace is not _NOOP:
            self._trace_flush()
            if self._stream_span is not None:
                self._stream_span.end(tokens=len(self.tokens))
                self._stream_span = None
            if state == COMPLETED:
                # exemplars: the TTFT / TPOT buckets name a trace id
                if self.ttft_ms is not None:
                    _tracing.note_exemplar(
                        "paddle_tpu_serving_ttft_ms", self.ttft_ms,
                        self.trace.trace_id, buckets=_MS_BUCKETS)
                if self.tpot_ms:
                    _tracing.note_exemplar(
                        "paddle_tpu_serving_tpot_ms", max(self.tpot_ms),
                        self.trace.trace_id, buckets=_MS_BUCKETS)
            self.trace.finish(
                state=state, error=error,
                prompt_tokens=len(self.prompt),
                generated=len(self.tokens),
                cached_tokens=self._cached_tokens or None,
                evictions=self.evictions or None,
                ttft_ms=round(self.ttft_ms, 3)
                if self.ttft_ms is not None else None,
                queue_ms=round(self.queue_ms, 3),
                prefill_ms=round(self.prefill_ms, 3),
                decode_ms=round(self.decode_ms, 3)
                if self.decode_ms is not None else None)
        self.events.put(("error", error) if error else ("done", None))
        self._done.set()

    # -- user side -----------------------------------------------------------

    @property
    def finished(self) -> bool:
        return self.state in _TERMINAL

    def result(self, timeout: float | None = None) -> list[int]:
        """Block until terminal; generated tokens, or raises ServingError."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not finished in {timeout}s "
                f"(state={self.state})")
        if self.error:
            raise ServingError(self.error)
        return list(self.tokens)

    def __repr__(self):
        return (f"Request({self.request_id}, state={self.state}, "
                f"prompt={len(self.prompt)}, generated={len(self.tokens)})")


class Scheduler:
    """Admission + continuous batching over ``max_batch`` decode slots.

    ``programs`` is the engine's device side: ``programs.prefill(request)
    -> int`` (the whole remaining context at once; the first sampled
    token), ``programs.prefill_chunk(request, n) -> int | None`` (``n``
    context tokens from ``request.prefilled``; the first sampled token on
    the final chunk) and ``programs.decode(tokens, positions, tables,
    temps) -> np.ndarray`` (one batched decode step) and, with ``spec_k``
    > 0, ``programs.verify(tokens, positions, dlens, tables, temps) ->
    (out, accepted)`` (one batched verify step over K + 1 lanes a row).
    ``prefill_chunk=None`` prefills monolithically at admission. The
    ``drafter`` attribute (an :class:`~.speculative.NgramDrafter` when
    speculating) may be replaced by any object with ``propose(history,
    k)``; one without a ``window`` attribute is handed the whole context.
    """

    def __init__(self, pool, programs, max_batch: int, max_seq_len: int,
                 eos_token_id=None, prefix_cache=None,
                 prefill_chunk: int | None = None,
                 prefill_budget: int | None = None,
                 spec_k: int = 0, spec_adaptive: bool = True):
        if prefill_chunk is not None and int(prefill_chunk) < 1:
            raise ValueError(f"prefill_chunk must be >= 1 tokens, got "
                             f"{prefill_chunk}")
        self.pool = pool
        self.programs = programs
        self.max_batch = int(max_batch)
        self.max_seq_len = int(max_seq_len)
        self.max_pages = pool.pages_for(self.max_seq_len)
        self.eos_token_id = eos_token_id
        self.prefix_cache = prefix_cache
        self.chunk = int(prefill_chunk) if prefill_chunk else None
        self.prefill_budget = int(prefill_budget) \
            if prefill_budget is not None else self.chunk
        self.spec_k = int(spec_k)
        self.spec_adaptive = bool(spec_adaptive)
        self.drafter = NgramDrafter() if self.spec_k else None
        self.lock = threading.RLock()
        self.waiting: list[Request] = []      # kept sorted by arrival
        self.slots: list[Request | None] = [None] * self.max_batch
        self.tables = np.zeros((self.max_batch, self.max_pages), np.int32)
        self.decode_steps = 0
        self.occupancy_sum = 0.0
        self.completed = 0
        self.evictions = 0
        # prefix-cache and prefill accounting (all under self.lock)
        self.prefix_page_hits = 0
        self.prefix_page_misses = 0
        self.prefix_tokens_saved = 0
        self.prompt_tokens = 0           # context tokens at admissions
        self.prefill_tokens_computed = 0
        self.cow_copies = 0
        self.chunks = 0
        # speculative accounting (under self.lock); step_tokens / step_rows
        # count generated tokens and participating rows over decode and
        # verify steps alike: their ratio is 1.0 without speculation
        self.spec_steps = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_rejected = 0
        self.step_tokens = 0
        self.step_rows = 0
        # lifecycle split (under self.lock): queue waits sum at each
        # admission, prefill and decode times at completion
        self.queue_wait_ms_sum = 0.0
        self.admissions = 0
        self.prefill_ms_sum = 0.0
        self.decode_ms_sum = 0.0
        self.finished_timed = 0

    # -- submission ----------------------------------------------------------

    def submit(self, req: Request) -> Request:
        total = len(req.prompt) + req.max_new_tokens
        if total > self.max_seq_len:
            req._finish(REJECTED, None)
            raise RequestRejected(
                f"prompt ({len(req.prompt)}) + max_new_tokens "
                f"({req.max_new_tokens}) = {total} exceeds max_seq_len "
                f"{self.max_seq_len}")
        if self.pool.pages_for(total) > self.pool.allocatable:
            req._finish(REJECTED, None)
            raise RequestRejected(
                f"request needs {self.pool.pages_for(total)} pages at "
                f"full length; pool holds {self.pool.allocatable}")
        if req.eos_token_id is None:
            req.eos_token_id = self.eos_token_id
        _SUBMITS.inc()
        _TOKENS.inc(len(req.prompt), kind="prompt")
        if _REC.enabled:
            _REC.record("serving_submit", request=req.request_id,
                        prompt=len(req.prompt), max_new=req.max_new_tokens)
        with self.lock:
            self._enqueue(req)
        return req

    def _enqueue(self, req: Request) -> None:
        """Insert keeping arrival order (evicted requests keep their place
        in line)."""
        i = len(self.waiting)
        while i > 0 and self.waiting[i - 1].arrival > req.arrival:
            i -= 1
        self.waiting.insert(i, req)
        req.state = QUEUED
        req._t_enqueued = time.monotonic()
        req._t_enqueued_wall = time.time()
        _QUEUE.set(len(self.waiting))

    # -- introspection -------------------------------------------------------

    def has_work(self) -> bool:
        with self.lock:
            return bool(self.waiting) or any(
                r is not None for r in self.slots)

    def active_requests(self) -> list[Request]:
        with self.lock:
            return [r for r in self.slots if r is not None]

    def queue_depth(self) -> int:
        with self.lock:
            return len(self.waiting)

    def prefix_hit_rate(self):
        """Context tokens served from the prefix cache over context tokens
        admitted (None before any admission or without a cache)."""
        with self.lock:
            if self.prefix_cache is None or not self.prompt_tokens:
                return None
            return self.prefix_tokens_saved / self.prompt_tokens

    def prefix_stats(self) -> dict:
        with self.lock:
            stats = {
                "page_hits": self.prefix_page_hits,
                "page_misses": self.prefix_page_misses,
                "tokens_saved": self.prefix_tokens_saved,
                "prompt_tokens": self.prompt_tokens,
                "prefill_tokens_computed": self.prefill_tokens_computed,
                "cow_copies": self.cow_copies,
                "enabled": self.prefix_cache is not None,
            }
        rate = self.prefix_hit_rate()
        stats["hit_rate"] = round(rate, 4) if rate is not None else None
        if self.prefix_cache is not None:
            stats["entries"] = len(self.prefix_cache)
        return stats

    def timing_split(self) -> dict:
        """Per-request lifecycle split: queue wait, prefill compute and
        decode wall means from the scheduler's sums, and p50s from the
        latency histograms (the ``/healthz`` serving payload)."""
        with self.lock:
            adm, fin = self.admissions, self.finished_timed
            out = {
                "queue_wait_ms_mean": round(
                    self.queue_wait_ms_sum / adm, 3) if adm else None,
                "prefill_ms_mean": round(
                    self.prefill_ms_sum / fin, 3) if fin else None,
                "decode_ms_mean": round(
                    self.decode_ms_sum / fin, 3) if fin else None,
            }
        for key, hist in (("queue_wait_p50_ms", _QUEUE_WAIT),
                          ("ttft_p50_ms", _TTFT),
                          ("tpot_p50_ms", _TPOT)):
            q = hist.quantile(0.5)
            out[key] = round(q, 3) if q is not None else None
        return out

    def spec_acceptance_rate(self):
        """Accepted over proposed drafts (None before any proposal)."""
        with self.lock:
            if not self.spec_proposed:
                return None
            return self.spec_accepted / self.spec_proposed

    def tokens_per_step(self):
        """Generated tokens per (decode or verify) step per participating
        request: 1.0 without speculation (None before any step)."""
        with self.lock:
            if not self.step_rows:
                return None
            return self.step_tokens / self.step_rows

    def spec_stats(self) -> dict:
        with self.lock:
            stats = {
                "enabled": self.spec_k > 0,
                "spec_k": self.spec_k,
                "adaptive": self.spec_adaptive,
                "verify_steps": self.spec_steps,
                "proposed_tokens": self.spec_proposed,
                "accepted_tokens": self.spec_accepted,
                "rejected_tokens": self.spec_rejected,
            }
        rate = self.spec_acceptance_rate()
        stats["acceptance_rate"] = round(rate, 4) if rate is not None \
            else None
        tps = self.tokens_per_step()
        stats["tokens_per_step"] = round(tps, 4) if tps is not None else None
        return stats

    # -- the iteration -------------------------------------------------------

    def step(self) -> bool:
        """One iteration (admit -> chunked prefill -> grow/evict -> batched
        decode). Returns True when any device work ran."""
        admitted = self._admit()
        chunked = self._prefill_chunks()
        decoded = self._decode()
        return bool(admitted or chunked or decoded)

    def drain_step(self) -> bool:
        """Shutdown-drain iteration: admission stays closed."""
        chunked = self._prefill_chunks()
        return bool(self._decode() or chunked)

    def _free_slot(self):
        for i, r in enumerate(self.slots):
            if r is None:
                return i
        return None

    def _claim_prefix(self, ctx, req: Request):
        """``(claimed_pages, chain_keys, matched_tokens)`` for one
        admission: claim the longest cached page-aligned prefix of ``ctx``
        (references taken). A full cover is capped at ``len(ctx) - 1``
        tokens: the last token is recomputed because its logits seed
        generation, and its KV write then copies the shared tail page. The
        keys are memoized on ``req``, so a blocked request does not hash
        its context again every iteration. Hits and misses are counted at
        admission, not here. Called under ``self.lock``."""
        cache = self.prefix_cache
        if cache is None:
            return [], [], 0
        if req._pending_keys_len == len(ctx):
            keys = req._pending_keys
        else:
            keys = cache.keys_for(ctx)
            req._pending_keys, req._pending_keys_len = keys, len(ctx)
        claimed = cache.claim(keys) if keys else []
        matched = len(claimed) * self.pool.page_size
        if matched >= len(ctx):
            matched = len(ctx) - 1
        return claimed, keys, matched

    def _insert_prefix(self, req: Request) -> None:
        """Register the now fully written full pages of ``req``'s context
        so later requests can claim them."""
        cache = self.prefix_cache
        if cache is None:
            return
        n_full = req._prefill_target // self.pool.page_size
        if n_full:
            cache.insert(req._chain_keys[:n_full], req.pages[:n_full])

    def _admit(self) -> int:
        admitted = 0
        ps = self.pool.page_size
        while True:
            t_adm0 = time.time()
            with self.lock:
                if not self.waiting:
                    break
                slot = self._free_slot()
                if slot is None:
                    break
                req = self.waiting[0]
                ctx = req.context()
                ctx_len = len(ctx)
                claimed, keys, matched = self._claim_prefix(ctx, req)
                # +1: headroom so the request's first decode write (the
                # token prefill samples) cannot evict at once
                need_new = self.pool.pages_for(ctx_len + 1) - len(claimed)
                if claimed and len(claimed) * ps >= ctx_len and \
                        self.pool.refcount(claimed[(ctx_len - 1) // ps]) > 1:
                    # full cover: the recomputed last token's write lands
                    # in a claimed page; when that page is shared, the
                    # copy-on-write takes one more page
                    need_new += 1
                if need_new > self.pool.available_pages:
                    if claimed:        # hand the claims back (cached state)
                        self.pool.free(claimed)
                    break                          # FIFO head-of-line wait
                try:
                    fresh = self.pool.alloc(
                        self.pool.pages_for(ctx_len) - len(claimed))
                except PagePoolExhausted:
                    if claimed:
                        self.pool.free(claimed)
                    break
                self.waiting.pop(0)
                _QUEUE.set(len(self.waiting))
                if self.prefix_cache is not None:
                    # admission succeeded: now the claim outcome counts
                    self.prefix_cache.note_result(len(claimed),
                                                  len(keys) - len(claimed))
                    self.prefix_page_hits += len(claimed)
                    self.prefix_page_misses += len(keys) - len(claimed)
                req.pages = claimed + fresh
                req.slot = slot
                req.prefilled = matched
                req._prefill_target = ctx_len
                req._cached_tokens = matched
                req._chain_keys = keys
                self.prefix_tokens_saved += matched
                self.prompt_tokens += ctx_len
                self.prefill_tokens_computed += ctx_len - matched
                row = self.tables[slot]
                row[:] = 0
                row[:len(req.pages)] = req.pages
                self.slots[slot] = req
                req.state = RUNNING
                if self.spec_k and req.spec is None:
                    req.spec = SpecState(self.spec_k, self.spec_adaptive)
                wait_ms = (time.monotonic() - req._t_enqueued) * 1000.0
                req.queue_ms += wait_ms
                self.queue_wait_ms_sum += wait_ms
                self.admissions += 1
                self._set_active()
            _QUEUE_WAIT.observe(wait_ms)
            if req.trace is not _NOOP:
                t_now = time.time()
                req.trace.add_span("queue_wait",
                                   t_start=req._t_enqueued_wall, t_end=t_now)
                req.trace.add_span("admit", t_start=t_adm0, t_end=t_now,
                                   cached_tokens=matched,
                                   claimed_pages=len(claimed),
                                   pages=len(req.pages), context=ctx_len,
                                   evictions=req.evictions)
            if matched and _REC.enabled:
                _REC.record("serving_prefix_hit", request=req.request_id,
                            pages=len(claimed), tokens=matched,
                            context=ctx_len)
            # a mid-page suffix start (full-cover cap) or any other write
            # into a shared page copies the page before device work
            if not self._make_writable(req, req.prefilled,
                                       ctx_len - req.prefilled):
                continue          # req was evicted while making headroom
            if self.chunk:
                admitted += 1
                continue          # chunked mode: device work interleaves
            t_pf0 = time.time()
            try:
                first = self.programs.prefill(req)
            except Exception as e:   # noqa: BLE001 — request-scoped failure
                self._release(req)
                req._finish(FAILED, f"prefill failed: {e!r}")
                continue
            t_pf1 = time.time()
            req.prefill_ms += (t_pf1 - t_pf0) * 1000.0
            if req.trace is not _NOOP:
                req.trace.add_span("prefill", t_start=t_pf0, t_end=t_pf1,
                                   tokens=ctx_len - matched,
                                   cached_tokens=matched)
            with self.lock:
                # the scheduler owns prefill progress; decode picks the
                # slot up only once this is set
                req.prefilled = req._prefill_target
                if matched:           # the suffix ran as one chunk
                    self.chunks += 1
            self._finish_prefill(req, first, matched)
            admitted += 1
        return admitted

    def _finish_prefill(self, req: Request, first: int,
                        cached_tokens: int) -> None:
        """Shared tail of a completed prefill (monolithic or final chunk):
        register the cacheable pages, emit the first token."""
        self._insert_prefix(req)
        if _MON.enabled:
            _PREFILLS.inc(bucket=str(self.programs.bucket_for(
                req._prefill_target)))
        if _REC.enabled:
            _REC.record("serving_prefill", request=req.request_id,
                        prompt=req.cur_len(), pages=len(req.pages),
                        cached_tokens=cached_tokens)
        req._emit(first)
        _TOKENS.inc(kind="generated")
        self._maybe_complete(req)

    def _set_active(self) -> None:
        """The active-requests gauge; caller holds the lock."""
        if _MON.enabled:
            _ACTIVE.set(sum(r is not None for r in self.slots))

    def _release(self, req: Request) -> None:
        """Take req out of its slot and drop its page references (shared
        pages stay live for their other owners; exclusive keyed pages fall
        to the cached state)."""
        req._trace_flush()        # a slot change ends the current burst
        with self.lock:
            if req.pages:
                self.pool.free(req.pages)
                req.pages = []
            if req.slot is not None:
                self.tables[req.slot][:] = 0
                self.slots[req.slot] = None
                if self.spec_k:
                    # the vacated slot no longer drafts
                    _SPEC_K.set(0, slot=str(req.slot))
                req.slot = None
            req.prefilled = 0
            req._prefill_target = 0
            self._set_active()

    def _maybe_complete(self, req: Request) -> bool:
        done_eos = (req.eos_token_id is not None and req.tokens
                    and req.tokens[-1] == req.eos_token_id)
        done_len = (len(req.tokens) >= req.max_new_tokens
                    or req.cur_len() >= self.max_seq_len)
        if not (done_eos or done_len):
            return False
        self._release(req)
        req._finish(COMPLETED)
        with self.lock:
            # stats() and health() read these from server threads
            self.completed += 1
            self.prefill_ms_sum += req.prefill_ms
            self.decode_ms_sum += req.decode_ms or 0.0
            self.finished_timed += 1
        if _REC.enabled:
            _REC.record("serving_complete", request=req.request_id,
                        generated=len(req.tokens),
                        reason="eos" if done_eos else "length")
        return True

    def _evict(self, victim: Request) -> None:
        self._release(victim)
        victim.evictions += 1
        _EVICTIONS.inc()
        if _REC.enabled:
            _REC.record("serving_evict", request=victim.request_id,
                        generated=len(victim.tokens))
        if victim.trace is not _NOOP:
            now = time.time()
            victim.trace.add_span("evict", t_start=now, t_end=now,
                                  generated=len(victim.tokens),
                                  evictions=victim.evictions)
        with self.lock:
            self.evictions += 1
            self._enqueue(victim)

    def _evict_for(self, req: Request) -> bool:
        """Pool exhausted while growing or copying for ``req``: evict the
        youngest OTHER active request. False when req itself is the
        youngest (or alone): req is evicted instead. Eviction drops only
        the victim's references, so a page shared with another request
        stays allocated for it."""
        with self.lock:
            others = [r for r in self.slots
                      if r is not None and r is not req]
        victim = max(others, key=lambda r: r.arrival, default=None)
        if victim is None or victim.arrival < req.arrival:
            self._evict(req)
            return False
        self._evict(victim)
        return True

    def _make_writable(self, req: Request, pos: int, n: int) -> bool:
        """Copy-on-write: every page holding positions ``[pos, pos + n)``
        of ``req`` must be exclusively owned before a KV write lands there.
        A page at refcount > 1 is copied to a fresh page and remapped in
        req's table; the shared original (and its cache entry) stays
        intact for its other owners. False when req lost its slot while
        making room for a copy."""
        if n <= 0:
            return req.slot is not None
        ps = self.pool.page_size
        for idx in range(pos // ps, (pos + n - 1) // ps + 1):
            while True:
                with self.lock:
                    if req.slot is None:
                        return False
                    if idx >= len(req.pages):
                        break        # not allocated yet: growth allocs fresh
                    page = req.pages[idx]
                    if self.pool.refcount(page) <= 1:
                        break        # exclusive already
                try:
                    fresh = self.pool.alloc(1)[0]
                except PagePoolExhausted:
                    if not self._evict_for(req):
                        return False
                    continue
                t_cp0 = time.time()
                self.pool.copy_page(page, fresh)
                with self.lock:
                    if req.slot is None:      # evicted meanwhile
                        self.pool.free([fresh])
                        return False
                    self.pool.free([req.pages[idx]])    # drop the shared ref
                    req.pages[idx] = fresh
                    self.tables[req.slot][idx] = fresh
                    self.cow_copies += 1
                _COW.inc()
                if _REC.enabled:
                    _REC.record("serving_cow", request=req.request_id,
                                src=int(page), page=int(fresh))
                if req.trace is not _NOOP:
                    req.trace.add_span("cow", t_start=t_cp0,
                                       t_end=time.time(), src=int(page),
                                       page=int(fresh))
                break
        return True

    def _prefill_chunks(self) -> int:
        """Chunked prefill: advance seated not-yet-prefilled requests by
        chunks, oldest first, spending at most ``prefill_budget`` tokens
        this iteration (the bound on how long prompt work can hold back
        the decodes in flight)."""
        if not self.chunk:
            return 0
        budget = self.prefill_budget or self.chunk
        ran = 0
        with self.lock:
            pending = sorted(
                (r for r in self.slots
                 if r is not None and not r.prefill_done),
                key=lambda r: r.arrival)
        for req in pending:
            if budget <= 0:
                break
            with self.lock:
                if req.slot is None or req.prefill_done:
                    continue
                start = req.prefilled
                n = min(self.chunk, req._prefill_target - start, budget)
            if n <= 0:
                continue
            if not self._make_writable(req, start, n):
                continue             # evicted while making room
            t_ch0 = time.time()
            try:
                tok = self.programs.prefill_chunk(req, n)
            except Exception as e:   # noqa: BLE001 — request-scoped failure
                self._release(req)
                req._finish(FAILED, f"prefill failed: {e!r}")
                continue
            t_ch1 = time.time()
            req.prefill_ms += (t_ch1 - t_ch0) * 1000.0
            if req.trace is not _NOOP:
                req.trace.add_span("prefill_chunk", t_start=t_ch0,
                                   t_end=t_ch1, start=start, n=n)
            budget -= n
            ran += 1
            with self.lock:
                req.prefilled = max(req.prefilled, start + n)
                self.chunks += 1
            if tok is not None:      # final chunk sampled the first token
                self._finish_prefill(req, tok, req._cached_tokens)
        return ran

    def _ensure_pages(self, req: Request) -> bool:
        """Grow req's table to cover its next write position (evicting the
        youngest active request on exhaustion) and copy the write page if
        it is shared. False when req is no longer seated."""
        if req.slot is None:
            return False
        while len(req.pages) < self.pool.pages_for(req.cur_len()):
            try:
                page = self.pool.alloc(1)[0]
            except PagePoolExhausted:
                if not self._evict_for(req):
                    return False
                continue
            with self.lock:
                req.pages.append(page)
                self.tables[req.slot][len(req.pages) - 1] = page
        return self._make_writable(req, req.cur_len() - 1, 1)

    def _masked_tables(self):
        """Page tables for one batched step: empty and still-prefilling
        slots ride with an all-trash row. Caller holds the lock."""
        tables = self.tables.copy()
        for i, r in enumerate(self.slots):
            if r is None or not r.prefill_done:
                tables[i][:] = 0
        return tables

    def _account_step(self, occ: float, emitted: int, rows: int,
                      proposed: int = 0, accepted: int = 0,
                      verify: bool = False) -> None:
        """Accounting shared by the decode and verify steps."""
        with self.lock:
            self.decode_steps += 1
            self.occupancy_sum += occ
            self.step_tokens += emitted
            self.step_rows += rows
            if verify:
                self.spec_steps += 1
                self.spec_proposed += proposed
                self.spec_accepted += accepted
                self.spec_rejected += proposed - accepted
        _STEPS.inc()
        _OCC.set(occ)

    def _decode(self) -> bool:
        with self.lock:
            active = [r for r in self.slots
                      if r is not None and r.prefill_done]
        if not active:
            return False
        drafts = self._propose(active) if self.spec_k else {}
        if any(drafts.values()):
            # every row's plain-decode page first, draft spans after: an
            # optional draft page must never take the last free page a
            # neighbour needs to decode
            for req in active:
                self._ensure_pages(req)
            for req, d in drafts.items():
                if d and not self._ensure_spec_pages(req, len(d)):
                    drafts[req] = []
                    # a failed span feeds the EWMA, so K backs off under
                    # memory pressure; not on eviction (slot None): a
                    # victim's acceptance rate says nothing of its drafts
                    if req.spec is not None and req.slot is not None:
                        req.spec.update(len(d), 0)
                        _SPEC_K.set(req.spec.k, slot=str(req.slot))
            if any(drafts.values()):
                return self._spec_decode(drafts)
            # every draft was dropped: a plain decode step, not a verify
        else:
            for req in active:
                self._ensure_pages(req)
        with self.lock:
            active = [r for r in self.slots
                      if r is not None and r.prefill_done]
            if not active:
                return False
            b = self.max_batch
            tokens = np.zeros(b, np.int32)
            positions = np.zeros(b, np.int32)
            temps = np.zeros(b, np.float32)
            for req in active:
                tokens[req.slot] = req.tokens[-1]
                positions[req.slot] = req.cur_len() - 1
                temps[req.slot] = max(req.temperature, 0.0)
            tables = self._masked_tables()
        t_dec0 = time.time()
        out = self.programs.decode(tokens, positions, tables, temps)
        self._account_step(len(active) / float(self.max_batch),
                           emitted=len(active), rows=len(active))
        # counted before any completion: a client that has its result
        # reads a counter that already holds its tokens
        _TOKENS.inc(len(active), kind="generated")
        for req in active:
            req._emit(int(out[req.slot]))
            req._trace_step("decode", t_dec0)
            self._maybe_complete(req)
        return True

    # -- speculative decoding ------------------------------------------------

    def _propose(self, active) -> dict:
        """``{request: drafts}``: up to K tokens a request from its own
        history, K from its adaptive state and capped so that a fully
        accepted burst stays inside ``max_new_tokens`` and
        ``max_seq_len``."""
        drafts: dict = {}
        # a window-bounded drafter sees only the context's tail; one
        # without a window gets the whole context
        window = getattr(self.drafter, "window", None)
        for req in active:
            st = req.spec
            k = st.draft_k() if st is not None else self.spec_k
            k = min(k, req.max_new_tokens - len(req.tokens) - 1,
                    self.max_seq_len - req.cur_len() - 1, self.spec_k)
            if k <= 0:
                drafts[req] = []
                continue
            hist = req.context_tail(window) if window else req.context()
            # a drafter that ignores k must not overflow the K + 1 lanes
            drafts[req] = [int(t) for t in self.drafter.propose(hist, k)][:k]
        return drafts

    def _ensure_spec_pages(self, req: Request, dlen: int) -> bool:
        """Grow req's table to hold the draft span (positions ``cur_len -
        1 .. cur_len - 1 + dlen``) and copy any shared page in it. On
        exhaustion the span is rolled back and False returned: speculation
        never costs another request its slot."""
        if req.slot is None:
            return False
        target = self.pool.pages_for(req.cur_len() + dlen)
        while len(req.pages) < target:
            try:
                page = self.pool.alloc(1)[0]
            except PagePoolExhausted:
                self._rollback(req)
                return False
            with self.lock:
                if req.slot is None:      # evicted meanwhile
                    self.pool.free([page])
                    return False
                req.pages.append(page)
                self.tables[req.slot][len(req.pages) - 1] = page
        return self._make_writable(req, req.cur_len() - 1, dlen + 1)

    def _rollback(self, req: Request) -> int:
        """Free the pages past what req's accepted length needs
        (``pages_for(cur_len)`` keeps the next write's page). They were
        allocated fresh for draft positions, never shared or keyed, so they
        go straight back to the free list. Returns how many."""
        with self.lock:
            if req.slot is None:
                return 0
            need = self.pool.pages_for(req.cur_len())
            extra = req.pages[need:]
            if not extra:
                return 0
            del req.pages[need:]
            self.tables[req.slot][need:need + len(extra)] = 0
            self.pool.free(extra)
        if _REC.enabled:
            _REC.record("serving_spec_rollback", request=req.request_id,
                        pages=len(extra))
        return len(extra)

    def _spec_decode(self, drafts: dict) -> bool:
        """One verify step over every prefill-complete row: emit each row's
        accepted drafts and its correction as one burst, stopping where
        sequential decoding would (``max_new_tokens``, eos), roll rejected
        pages back and feed the adaptive K. ``_decode`` has secured every
        row's pages and grown the surviving draft spans."""
        with self.lock:
            active = [r for r in self.slots
                      if r is not None and r.prefill_done]
            if not active:
                return False
            b, s = self.max_batch, self.spec_k + 1
            tokens = np.zeros((b, s), np.int32)
            positions = np.zeros(b, np.int32)
            dlens = np.zeros(b, np.int32)
            temps = np.zeros(b, np.float32)
            for req in active:
                d = drafts.get(req) or []
                tokens[req.slot, 0] = req.tokens[-1]
                tokens[req.slot, 1:1 + len(d)] = d
                positions[req.slot] = req.cur_len() - 1
                dlens[req.slot] = len(d)
                temps[req.slot] = max(req.temperature, 0.0)
            tables = self._masked_tables()
            n_prop = int(dlens.sum())
        if _REC.enabled:
            _REC.record("serving_spec_propose", rows=len(active),
                        proposed=n_prop)
        t_ver0 = time.time()
        out, acc = self.programs.verify(tokens, positions, dlens, tables,
                                        temps)
        n_acc = n_emit = 0
        for req in active:
            a = int(acc[req.slot])
            emitted = [int(t) for t in out[req.slot, :a + 1]]
            emitted = emitted[:req.max_new_tokens - len(req.tokens)]
            if req.eos_token_id is not None and req.eos_token_id in emitted:
                emitted = emitted[:emitted.index(req.eos_token_id) + 1]
            req._emit_burst(emitted)
            _TOKENS.inc(len(emitted), kind="generated")
            n_acc += a
            n_emit += len(emitted)
            d_n = int(dlens[req.slot])
            if req.spec is not None and d_n:
                req.spec.update(d_n, a)
            if req.spec is not None and req.slot is not None:
                # every step: the gauge follows adaptive K down to 0
                _SPEC_K.set(req.spec.k, slot=str(req.slot))
            rb = self._rollback(req)
            req._trace_step("speculate", t_ver0, tokens=len(emitted),
                            proposed=d_n, accepted=a, rollback_pages=rb)
            self._maybe_complete(req)
        self._account_step(len(active) / float(self.max_batch),
                           emitted=n_emit, rows=len(active),
                           proposed=n_prop, accepted=n_acc, verify=True)
        if _MON.enabled:
            if n_prop:
                _SPEC_PROPOSED.inc(n_prop)
            if n_acc:
                _SPEC_ACCEPTED.inc(n_acc)
            if n_prop - n_acc:
                _SPEC_REJECTED.inc(n_prop - n_acc)
            # windowed deltas, not a ratio of rates: the two counters'
            # window bases tick apart, so a ratio of rates can read > 1
            prop_delta = _SPEC_PROPOSED.delta(60.0)
            if prop_delta > 0:
                _SPEC_RATE.set(round(
                    min(1.0, _SPEC_ACCEPTED.delta(60.0) / prop_delta), 4))
        if _REC.enabled:
            _REC.record("serving_spec_verify", accepted=n_acc,
                        rejected=n_prop - n_acc, emitted=n_emit)
        return True

    # -- shutdown ------------------------------------------------------------

    def abort_queued(self, error: str) -> int:
        with self.lock:
            doomed, self.waiting = self.waiting, []
            _QUEUE.set(0)
        for req in doomed:
            req._finish(FAILED, error)
        return len(doomed)

    def abort_active(self, error: str) -> int:
        n = 0
        for req in self.active_requests():
            self._release(req)
            req._finish(FAILED, error)
            n += 1
        return n
