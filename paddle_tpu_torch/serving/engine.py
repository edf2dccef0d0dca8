"""LLMEngine: the threaded serving front over the paged-KV scheduler
(counterpart of ``paddle_tpu/serving/engine.py``).

User surface::

    engine = LLMEngine(model, ServingConfig(max_batch=8))
    req = engine.submit([1, 2, 3], max_new_tokens=16)    # non-blocking
    for tok in engine.stream([1, 2, 3]):                  # token stream
        ...
    toks = engine.generate([1, 2, 3])                     # blocking
    engine.shutdown(drain=True)

A background thread runs scheduler iterations whenever work exists. The
forwards run eagerly (no ``torch.compile``); grad mode is thread-local in
PyTorch, so the engine thread wraps its own work in
``torch.inference_mode()``. Next tokens are chosen on the device: greedy
where a row's temperature is 0, else temperature (and optional top-k)
Gumbel sampling from the engine's seeded ``torch.Generator``. With
``spec_k`` K > 0 a step where any request drafted runs :meth:`verify` over
K + 1 lanes a row (``serving/speculative.py``), its acceptance draws from
the same generator.

``serving.server.serve(engine, port)`` mounts the engine on the telemetry
server (``POST /generate``, the serving ``/healthz``). ``health()`` is
that liveness payload. ``install_preemption()`` arms SIGTERM to drain the
requests in flight, dump the flight recorder (reason
``serving_preempted``, with the spans open at the signal), shut the
telemetry server down and exit 143, as the JAX engine does.
"""

from __future__ import annotations

import queue
import signal
import threading
import time
import warnings
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..device import resolve_device
from ..observability import flight as _flight
from ..observability import metrics as _metrics
from .kv_cache import PagePool
from .model import ServingModel
from .prefix_cache import PrefixCache, model_fingerprint
from .scheduler import Request, Scheduler, ServingError
from .speculative import scaled_filtered_logits, verify_tokens

__all__ = ["ServingConfig", "LLMEngine"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

_CHUNKS = _metrics.counter("paddle_tpu_serving_prefill_chunks_total",
                           "chunked-prefill program runs (incl. cache-hit "
                           "suffix chunks)")
_REC = _flight.get_recorder()


@dataclass
class ServingConfig:
    """Static knobs of the serving runtime. The defaults are the JAX
    engine's (``paddle_tpu/serving/engine.py:62-107``) for every ported
    option: monolithic prefill, the fused block epilogues and the prefix
    cache. ``quant`` ("weight_only_int8" | "weight_only_int4", with
    ``quant_group_size`` G > 0 for scales per group of G input features)
    runs every decoder-layer projection through the weight-only kernels.
    ``spec_k`` > 0 turns on speculative decoding with up to that many
    n-gram drafts a request and step (``spec_adaptive`` moves each
    request's K on its acceptance rate); ``prefill_budget`` caps the
    prefill tokens an iteration of chunked prefill spends (default: one
    chunk)."""
    page_size: int = 16          # token positions per KV page
    num_pages: int = 64          # pool pages incl. the reserved trash page
    max_batch: int = 8           # decode slots (the continuous batch)
    max_seq_len: int | None = None   # default: model max_position_embeddings
    max_new_tokens: int = 32     # per-request default
    temperature: float = 0.0     # per-request default (0 = greedy)
    top_k: int | None = None     # sampling filter
    eos_token_id: int | None = None
    quant: str | None = None     # None | weight_only_int8 | weight_only_int4
    quant_group_size: int = -1   # -1: one scale per output channel
    fused_block: bool = True     # block-epilogue kernels at every residual
    #                              junction
    fused_decode_layer: bool = False   # one decode-layer kernel launch
    #                              per layer and decode step (block_i tuned
    #                              at construction)
    prefix_cache: bool = True    # copy-on-write KV page sharing across
    #                              requests with a common prompt prefix
    prefill_chunk: int | None = None   # tokens per prefill chunk (None =
    #                              monolithic prefill at admission)
    prefill_budget: int | None = None   # chunked-prefill tokens per
    #                              iteration (None = one chunk)
    spec_k: int = 0              # max draft tokens per request and step
    #                              (0 = no speculative decoding)
    spec_adaptive: bool = True   # shrink / grow each request's K on its
    #                              acceptance-rate EWMA (K 0 = plain decode)
    dtype: str = "float32"       # KV pool dtype
    seed: int = 0
    flight_every: int = 50       # decode-step flight event cadence
    drain_timeout_s: float = 30.0


def _auto_buckets(max_seq_len: int) -> tuple:
    out, b = [], 8
    while b < max_seq_len:
        out.append(b)
        b *= 2
    out.append(max_seq_len)
    return tuple(sorted(set(out)))


class LLMEngine:
    """Continuous-batching serving engine over a paged KV cache, on
    ``device`` (default ``cuda``; the model must already live there)."""

    def __init__(self, model, config: ServingConfig | None = None,
                 device=None, **overrides):
        cfg = config or ServingConfig()
        if overrides:
            cfg = replace(cfg, **overrides)
        if cfg.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got "
                             f"{cfg.dtype!r}")
        want = resolve_device(device)
        self.device = next(model.parameters()).device
        if self.device.type != want.type or \
                want.index not in (None, self.device.index):
            raise ValueError(f"model lives on {self.device}, engine asked "
                             f"for {want}")
        self.config = cfg
        self._sm = ServingModel(model, quant=cfg.quant,
                                quant_group_size=cfg.quant_group_size,
                                fused_block=cfg.fused_block,
                                fused_decode_layer=cfg.fused_decode_layer)
        max_seq = cfg.max_seq_len or self._sm.max_pos
        if max_seq > self._sm.max_pos:
            raise ValueError(
                f"max_seq_len {max_seq} exceeds the model's "
                f"max_position_embeddings {self._sm.max_pos}")
        self.max_seq_len = int(max_seq)
        if cfg.prefill_budget is not None and cfg.prefill_budget < 1:
            raise ValueError(
                f"prefill_budget must be >= 1 tokens, got {cfg.prefill_budget}")
        if cfg.prefill_budget is not None and cfg.prefill_chunk is None:
            raise ValueError(
                "prefill_budget only caps CHUNKED prefill — set "
                "prefill_chunk too (monolithic prefill cannot be budgeted)")
        if cfg.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {cfg.spec_k}")
        if cfg.spec_k >= self.max_seq_len:
            raise ValueError(
                f"spec_k {cfg.spec_k} >= max_seq_len {self.max_seq_len}: "
                f"a draft span could never fit a sequence")
        self.pool = PagePool(
            num_layers=len(model.layers), num_pages=cfg.num_pages,
            num_kv_heads=self._sm.n_kv, page_size=cfg.page_size,
            head_dim=self._sm.head_dim, dtype=_DTYPES[cfg.dtype],
            device=self.device)
        self._sm.bind_pool(self.pool)
        self.prefix_cache = None
        if cfg.prefix_cache:
            self.prefix_cache = PrefixCache(self.pool, model_fingerprint(
                model, quant=cfg.quant,
                quant_group_size=cfg.quant_group_size, dtype=cfg.dtype,
                page_size=cfg.page_size))
        self.scheduler = Scheduler(self.pool, self, cfg.max_batch,
                                   self.max_seq_len,
                                   eos_token_id=cfg.eos_token_id,
                                   prefix_cache=self.prefix_cache,
                                   prefill_chunk=cfg.prefill_chunk,
                                   prefill_budget=cfg.prefill_budget,
                                   spec_k=cfg.spec_k,
                                   spec_adaptive=cfg.spec_adaptive)
        # the JAX engine compiles one prefill program per bucket; the port
        # runs each prompt at its own length and keeps the buckets only to
        # validate a prompt's length the same way
        self.buckets = _auto_buckets(self.max_seq_len)
        self.tuning = None     # the block_i tuning entry (or None)
        if cfg.fused_decode_layer:
            self._setup_fused_layer()
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        # host-clock milliseconds of each monolithic prefill (a prefix hit
        # runs its suffix as one chunk and counts here), each chunk of
        # chunked prefill, each decode step and each verify step, each
        # ending in a device synchronise
        self.prefill_ms: list[float] = []
        self.chunk_ms: list[float] = []
        self.step_ms: list[float] = []
        self.verify_ms: list[float] = []
        self._cond = threading.Condition()
        self._thread: threading.Thread | None = None
        self._stop_mode: str | None = None
        self._drain_deadline = 0.0
        self._t_started: float | None = None
        self._last_step_wall: float | None = None
        self._old_handlers: dict = {}
        # preemption: the SIGNAL handler only writes _preempt_code and
        # waits on _drained; the engine thread sees the flag within one
        # loop tick, drains, dumps, and sets the event
        self._preempt_code: int | None = None
        self._drained = threading.Event()
        # the open spans at the signal, taken on the engine thread when
        # the drain arms (the dump must carry them, not the drained state)
        self._preempt_spans: list | None = None

    def _setup_fused_layer(self):
        """On the card, refuse a model or batch the decode-layer kernel does
        not take (never run the composite in its place); then tune block_i
        before the first decode step, as the JAX engine does
        (``paddle_tpu/serving/engine.py:185-192``)."""
        sm, cfg = self._sm, self.config
        if self.device.type == "cuda":
            why = "fused_block=False or biased o/gate/up/down projections" \
                if not sm.fused_decode_layer else sm.decode_layer_refusal(
                    cfg.max_batch, self.scheduler.max_pages)
            if why:
                raise ValueError(f"fused_decode_layer=True: the decode-layer "
                                 f"kernel does not take {why}")
        if sm._fused_layer_active():
            from ..ops.kernels import autotune
            self.tuning = autotune.tune_for_serving(
                sm, cfg.page_size, cfg.num_pages, self.scheduler.max_pages,
                cfg.max_batch)

    # -- device side the scheduler drives --------------------------------------

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _sample(self, logits, temps: np.ndarray):
        """Next token per row of ``logits [N, V]``: greedy where
        ``temps == 0``, else temperature (+ top_k) Gumbel sampling.
        Returns int64 ``[N]`` on the device."""
        logits = logits.float()
        greedy = logits.argmax(-1)
        if not (temps > 0).any():
            return greedy
        t = torch.as_tensor(temps, dtype=torch.float32, device=self.device)
        arr = scaled_filtered_logits(logits, t, self.config.top_k)
        u = torch.rand(arr.shape, generator=self._gen, device=self.device)
        u = u.clamp_(min=torch.finfo(torch.float32).tiny)
        sampled = (arr - torch.log(-torch.log(u))).argmax(-1)
        return torch.where(t > 0, sampled, greedy)

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        raise ServingError(f"no prefill bucket holds length {n} "
                           f"(buckets={self.buckets})")

    def _row(self, req: Request):
        row = np.zeros(self.scheduler.max_pages, np.int32)
        row[:len(req.pages)] = req.pages
        return torch.from_numpy(row).to(self.device)

    def _first_token(self, req: Request, logits) -> int:
        temps = np.asarray([max(req.temperature, 0.0)], np.float32)
        return int(self._sample(logits, temps)[0])      # synchronises

    def prefill(self, req: Request) -> int:
        """Whole-context prefill at admission; returns the first sampled
        token. With a prefix-cache hit (``req.prefilled > 0``) only the
        suffix runs, as one chunk against the claimed pages; otherwise the
        monolithic forward runs over the context at its own length."""
        t0 = time.perf_counter()
        ctx = req.context()
        self.bucket_for(len(ctx))
        if req.prefilled:
            tok = self._chunk(req, len(ctx) - req.prefilled)
        else:
            toks = torch.tensor([ctx], dtype=torch.long, device=self.device)
            logits = self._sm.prefill_forward(toks, len(ctx), self._row(req))
            req.prefilled = len(ctx)
            tok = self._first_token(req, logits)
        self.prefill_ms.append((time.perf_counter() - t0) * 1000.0)
        self._last_step_wall = time.time()
        return tok

    def _chunk(self, req: Request, n: int):
        """Run ``n`` context tokens of ``req`` from ``req.prefilled``.
        Returns the first sampled token on the final chunk, else None."""
        ctx = req.context()
        start = req.prefilled
        toks = torch.tensor([ctx[start:start + n]], dtype=torch.long,
                            device=self.device)
        logits = self._sm.prefill_chunk_forward(toks, start, n,
                                                self._row(req))
        req.prefilled = start + n
        _CHUNKS.inc()
        if req.prefilled >= len(ctx):
            return self._first_token(req, logits)
        self._sync()
        return None

    def prefill_chunk(self, req: Request, n: int):
        """One chunk of chunked prefill (:meth:`_chunk`), timed."""
        t0 = time.perf_counter()
        tok = self._chunk(req, n)
        self.chunk_ms.append((time.perf_counter() - t0) * 1000.0)
        self._last_step_wall = time.time()
        return tok

    def decode(self, tokens, positions, tables, temps):
        t0 = time.perf_counter()
        dev = self.device
        logits = self._sm.decode_forward(
            torch.from_numpy(tokens).to(dev), torch.from_numpy(positions).to(dev),
            torch.from_numpy(tables).to(dev))
        out = self._sample(logits, temps).cpu().numpy()
        self.step_ms.append((time.perf_counter() - t0) * 1000.0)
        self._last_step_wall = time.time()
        if _REC.enabled and self.scheduler.decode_steps % \
                max(1, self.config.flight_every) == 0:
            _REC.record("serving_decode", step=self.scheduler.decode_steps,
                        active=len(self.scheduler.active_requests()),
                        free_pages=self.pool.free_pages)
        return out

    def verify(self, tokens, positions, dlens, tables, temps):
        """One speculative verify step: tokens ``[B, K + 1]`` (each row's
        last emitted token, then its drafts), positions / dlens / temps
        ``[B]``, tables ``[B, max_pages]``. Returns ``(out [B, K + 1],
        accepted [B])``: row ``b`` emits ``out[b, :accepted[b] + 1]``. One
        transfer to the host a step, as :meth:`decode`."""
        t0 = time.perf_counter()
        dev = self.device
        toks = torch.from_numpy(tokens).to(dev)
        logits = self._sm.verify_forward(
            toks, torch.from_numpy(positions).to(dev),
            torch.from_numpy(dlens).to(dev), torch.from_numpy(tables).to(dev))
        out, acc = verify_tokens(
            logits, toks[:, 1:], torch.from_numpy(dlens).to(dev),
            torch.from_numpy(temps).to(dev), self._gen, self.config.top_k)
        arr = torch.cat([out, acc[:, None]], dim=1).cpu().numpy()
        self.verify_ms.append((time.perf_counter() - t0) * 1000.0)
        self._last_step_wall = time.time()
        return arr[:, :-1], arr[:, -1]

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "LLMEngine":
        with self._cond:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop_mode = None
            self._t_started = time.time()
            self._thread = threading.Thread(
                target=self._loop, name="paddle-tpu-torch-serving",
                daemon=True)
            self._thread.start()
        return self

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _loop(self):
        # grad mode is per thread: the caller's no_grad does not reach here
        with torch.inference_mode():
            self._run()
        if self._preempt_code is not None:
            self._finish_preemption()

    def _arm_preempt_drain(self):
        """A signal asked for a drain: the handler only set a flag (it may
        take no lock), the engine thread arms the drain here and keeps
        the spans open at this moment for the dump."""
        with self._cond:
            if self._stop_mode is not None:
                return
            self._drain_deadline = time.monotonic() + \
                self.config.drain_timeout_s
            self._stop_mode = "drain"
        try:
            from ..observability import tracing as _tracing
            self._preempt_spans = _tracing.open_spans()
        except Exception:   # noqa: BLE001 — the dump must still happen
            self._preempt_spans = None

    def _run(self):
        sched = self.scheduler
        while True:
            if self._preempt_code is not None and self._stop_mode is None:
                self._arm_preempt_drain()
            with self._cond:
                while self._stop_mode is None and not sched.has_work():
                    self._cond.wait(0.05)
                    if self._preempt_code is not None:
                        break
                mode = self._stop_mode
            if mode is None and self._preempt_code is not None:
                continue        # arm the drain at the top of the loop
            if mode == "abort":
                break
            try:
                if mode == "drain":
                    sched.abort_queued("engine draining (shutdown)")
                    if not sched.active_requests() or \
                            time.monotonic() > self._drain_deadline:
                        break
                    sched.drain_step()
                else:
                    sched.step()
            except Exception as e:       # noqa: BLE001 — engine boundary
                self._engine_error(e)
                break

    def _finish_preemption(self):
        """After a signal-requested drain, on the engine thread: fail what
        is left, dump the flight recorder, close the telemetry server,
        then release the waiting signal handler."""
        try:
            self._finalize(drain=True)
            extra = {"serving": self.stats()}
            if self._preempt_spans is not None:
                extra["tracing_at_preempt"] = {
                    "open_spans": self._preempt_spans}
            _flight.dump("serving_preempted",
                         step=self.scheduler.decode_steps, extra=extra)
            try:
                from ..observability.continuous import shutdown_server
                shutdown_server()
            except Exception:   # noqa: BLE001 — the drain must finish
                pass
        finally:
            self._drained.set()

    def _engine_error(self, e: Exception):
        """A device failure is engine-fatal: every request fails loudly
        rather than hanging."""
        msg = f"serving engine error: {type(e).__name__}: {e}"
        _flight.record("serving_engine_error", error=repr(e)[:300])
        self.scheduler.abort_active(msg)
        self.scheduler.abort_queued(msg)
        with self._cond:
            self._stop_mode = "abort"

    def shutdown(self, drain: bool = True,
                 timeout: float | None = None) -> dict:
        """Stop the engine. ``drain=True`` finishes in-flight requests
        (bounded by ``timeout``, default ``drain_timeout_s``) and fails
        queued ones; ``drain=False`` fails everything at once. Returns a
        summary; the pool is left leak-free."""
        timeout = self.config.drain_timeout_s if timeout is None \
            else float(timeout)
        with self._cond:
            self._drain_deadline = time.monotonic() + timeout
            self._stop_mode = "drain" if drain else "abort"
            self._cond.notify_all()
        if self._thread is not None and self._thread.is_alive() and \
                threading.current_thread() is not self._thread:
            self._thread.join(timeout + 5.0)
            if self._thread.is_alive():
                warnings.warn(
                    f"serving engine thread did not exit within "
                    f"{timeout + 5.0:.1f}s of shutdown; failing requests "
                    f"anyway", RuntimeWarning, stacklevel=2)
        return self._finalize(drain)

    def _finalize(self, drain: bool) -> dict:
        """Fail what remains and record the drain event; shared by
        :meth:`shutdown` and the preemption path."""
        n_queued = self.scheduler.abort_queued("engine shut down")
        n_active = self.scheduler.abort_active(
            "drain timeout exceeded" if drain
            else "engine shut down before completion")
        summary = {"drained": drain, "failed_queued": n_queued,
                   "failed_active": n_active,
                   "completed": self.scheduler.completed,
                   "pages_leaked": self.pool.leaked()}
        _flight.record("serving_drain", **summary)
        return summary

    def close(self):
        self.shutdown(drain=False)

    def __enter__(self) -> "LLMEngine":
        return self.start()

    def __exit__(self, *exc):
        self.shutdown(drain=exc == (None, None, None))
        return False

    # -- request surface -----------------------------------------------------

    def submit(self, prompt_ids, max_new_tokens: int | None = None,
               temperature: float | None = None, eos_token_id=None,
               request_id: str | None = None, on_token=None,
               traceparent: str | None = None) -> Request:
        """Enqueue one request (starts the engine thread). Raises
        :class:`RequestRejected` when the request can never fit.
        ``traceparent`` joins an inbound W3C trace context (a malformed
        value gives the request a fresh trace)."""
        cfg = self.config
        req = Request(
            prompt_ids,
            cfg.max_new_tokens if max_new_tokens is None else max_new_tokens,
            cfg.temperature if temperature is None else temperature,
            eos_token_id=eos_token_id, request_id=request_id,
            on_token=on_token, traceparent=traceparent)
        self.scheduler.submit(req)
        self.start()
        with self._cond:
            self._cond.notify_all()
        return req

    def stream(self, prompt_ids, timeout: float = 300.0, **kw):
        """Generator of generated token ids; raises ServingError on a
        failed request, TimeoutError when no token arrives within
        ``timeout`` seconds."""
        req = self.submit(prompt_ids, **kw)
        while True:
            try:
                kind, val = req.events.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(
                    f"request {req.request_id} produced no token in "
                    f"{timeout}s (state={req.state})") from None
            if kind == "token":
                yield val
            elif kind == "done":
                return
            else:
                raise ServingError(val)

    def generate(self, prompt_ids, timeout: float = 300.0, **kw):
        """Blocking convenience: submit + result."""
        return self.submit(prompt_ids, **kw).result(timeout)

    def stats(self) -> dict:
        """The JAX engine's keys but ``programs``: the port traces no
        programs, so it has no retrace counts to report."""
        sched = self.scheduler
        steps = sched.decode_steps
        return {
            "queue_depth": sched.queue_depth(),
            "active_requests": len(sched.active_requests()),
            "max_batch": sched.max_batch,
            "decode_steps": steps,
            "prefill_chunks": sched.chunks,
            "completed": sched.completed,
            "evictions": sched.evictions,
            "occupancy_mean": (sched.occupancy_sum / steps) if steps else 0.0,
            "pages": {"free": self.pool.free_pages,
                      "used": self.pool.used_pages,
                      "cached": self.pool.cached_pages,
                      "shared": self.pool.shared_pages,
                      "lost": self.pool.lost(),
                      "total": self.pool.allocatable},
            "prefix_cache": sched.prefix_stats(),
            "speculative": sched.spec_stats(),
            "tokens_per_step": sched.tokens_per_step(),
        }

    def health(self, stall_after_s: float = 120.0) -> tuple[int, dict]:
        """Serving liveness: ``(http_code, payload)``. Healthy while idle;
        stalled (503) when work exists but no prefill or decode step has
        run within ``stall_after_s``."""
        sched = self.scheduler
        active = len(sched.active_requests())
        depth = sched.queue_depth()
        ref = self._last_step_wall or self._t_started
        age = (time.time() - ref) if ref is not None else None
        if not (active or depth):
            status = "idle"
        elif age is None:
            status = "stalled" if not self.running else "starting"
        else:
            status = "ok" if age <= stall_after_s else "stalled"
        tok = _metrics.get_registry().get("paddle_tpu_serving_tokens_total")
        payload = {
            "mode": "serving",
            "status": status,
            "decode_steps": sched.decode_steps,
            "last_step_age_s": round(age, 3) if age is not None else None,
            "stall_after_s": stall_after_s,
            "active_requests": active,
            "queue_depth": depth,
            "tokens_per_s": round(
                tok.rate(60.0, kind="generated"), 4) if tok else 0.0,
            "kv_pages_free": self.pool.free_pages,
            "kv_pages_used": self.pool.used_pages,
            "kv_pages_cached": self.pool.cached_pages,
            "prefix_hit_rate": sched.prefix_hit_rate(),
            "spec_acceptance_rate": sched.spec_acceptance_rate(),
            "timing_split": sched.timing_split(),
        }
        return (503 if status == "stalled" else 200), payload

    # -- preemption ----------------------------------------------------------

    def install_preemption(self, exit_code: int = 143,
                           signals=(signal.SIGTERM,)) -> "LLMEngine":
        """Arm signal-driven drain: on SIGTERM the engine drains the
        requests in flight, dumps the flight recorder (reason
        ``serving_preempted``), shuts the telemetry server down and exits
        ``exit_code``.

        The handler records a flight event (lock-free), writes one
        attribute and waits, bounded, for the ENGINE thread to drain,
        dump and shut the server down: taking the engine condition or the
        scheduler lock here would deadlock whenever the signal lands while
        the interrupted frame holds it."""

        def _handler(signum, frame):
            _flight.record("serving_preempt", signum=int(signum))
            self._preempt_code = int(exit_code)
            # waited in slices, so an engine thread that exits without
            # running the preemption tail is noticed within one slice
            deadline = time.monotonic() + \
                self.config.drain_timeout_s + 30.0
            drained = False
            last_steps = self.scheduler.decode_steps
            stalled = 0
            while time.monotonic() < deadline:
                if self._drained.wait(0.2):
                    drained = True
                    break
                if not self.running:
                    break
                steps = self.scheduler.decode_steps
                if steps == last_steps:
                    stalled += 1
                    if stalled >= 50:
                        # ~10 s without a decode step: the signal likely
                        # interrupted a frame holding a lock the drain
                        # needs; exit with the dump
                        break
                else:
                    stalled, last_steps = 0, steps
            drained = drained or self._drained.is_set()
            if not drained:
                if self.running:
                    _flight.record("serving_drain_timeout",
                                   timeout_s=self.config.drain_timeout_s)
                _flight.dump("serving_preempted",
                             step=self.scheduler.decode_steps)
            raise SystemExit(exit_code)

        for sig in signals:
            self._old_handlers[sig] = signal.signal(sig, _handler)
        return self

    def uninstall_preemption(self) -> None:
        for sig, old in self._old_handlers.items():
            try:
                signal.signal(sig, old)
            except (ValueError, OSError):
                pass
        self._old_handlers.clear()
