"""Measured tuning of the decode-layer kernel's ``block_i``, with a
persistent tuning cache (counterpart of ``paddle_tpu/ops/kernels/
autotune.py``).

Tuning a kernel is: time each candidate on the card, persist the winner,
install it through the override registry the kernel's picker reads
(:func:`decode_layer.set_block_override` under
:data:`decode_layer.BLOCK_I_KEY`).

**Cache key.** Entries are keyed by a blake2b fingerprint over everything
that invalidates a measurement: kernel name, argument shapes, dtypes, quant
layout, ``torch.__version__``, the CUDA device's name and the built
kernel library's name, which carries the hash of its sources and flags
(``_build.lib_path``), so an edited kernel is measured again. (The JAX
tuner keys on ``jax.__version__`` and a TPU chip preset instead.) The
cache file is JSON at ``$PADDLE_TPU_TUNE_CACHE`` (default
``~/.cache/paddle_tpu/tuning_cache.json``), written atomically (tmp +
rename) so a crashed trial never truncates earlier winners.

**Round trip.** The first run measures every candidate and persists the
winner; a second run with the same key loads it with zero trials, as the
``hits`` / ``misses`` / ``measure_seconds`` counters show. A changed key is
a miss and measures again.

The trial times a candidate with CUDA events on synthetic inputs at the
real serving shape, made from a seeded ``torch.Generator``. With no card to
measure on and no injected trial, nothing is measured and nothing changes.

``PADDLE_TPU_TUNE=0`` skips measurement (a cache hit still installs:
loading a persisted winner costs nothing).
"""

from __future__ import annotations

import hashlib
import json
import os
import time

import torch

from . import _build
from .decode_layer import (BLOCK_I_KEY, decode_layer, set_block_override,
                           use_kernel)

__all__ = ["kernel_fingerprint", "TuningCache", "default_cache",
           "tuning_enabled", "tune_decode_layer", "tune_for_serving",
           "lookup_measured", "cuda_trial"]

_CACHE_ENV = "PADDLE_TPU_TUNE_CACHE"
_TUNE_ENV = "PADDLE_TPU_TUNE"
KERNEL = "block_decode_layer"


def tuning_enabled() -> bool:
    """Measurement gate (cache hits load regardless: only new trials can
    be skipped)."""
    return os.environ.get(_TUNE_ENV, "1") != "0"


def kernel_fingerprint(kernel, shapes=(), dtypes=(), device=None,
                       quant=None, kernel_hash=None) -> str:
    """Cache key: blake2b over every measurement invalidator (kernel name,
    shapes, dtypes, device name, quant layout, kernel library hash, torch
    version). A changed input is a changed key, never a stale read."""
    payload = repr((str(kernel), tuple(tuple(s) for s in shapes),
                    tuple(str(d) for d in dtypes), str(device), str(quant),
                    str(kernel_hash), torch.__version__))
    return hashlib.blake2b(payload.encode(), digest_size=16).hexdigest()


class TuningCache:
    """JSON-persisted winners plus per-process counters: ``get`` counts hits
    and misses, ``add_measure_seconds`` the wall time spent in trials, so a
    second run can show that it measured nothing."""

    def __init__(self, path=None):
        self.path = path or os.environ.get(_CACHE_ENV) or os.path.join(
            os.path.expanduser("~"), ".cache", "paddle_tpu",
            "tuning_cache.json")
        self.hits = 0
        self.misses = 0
        self.measure_seconds = 0.0
        self._entries = None

    def _load(self) -> dict:
        if self._entries is None:
            try:
                with open(self.path, encoding="utf-8") as f:
                    data = json.load(f)
                self._entries = dict(data) if isinstance(data, dict) else {}
            except (OSError, ValueError):
                self._entries = {}
        return self._entries

    def get(self, key):
        entry = self._load().get(key)
        if entry is None:
            self.misses += 1
        else:
            self.hits += 1
        return entry

    def peek(self, key):
        """Lookup without touching the hit/miss counters."""
        return self._load().get(key)

    def put(self, key, entry) -> None:
        entries = self._load()
        entries[str(key)] = entry
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(entries, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)  # atomic: a crash never truncates
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def add_measure_seconds(self, seconds: float) -> None:
        self.measure_seconds += float(seconds)

    def entries(self) -> dict:
        return dict(self._load())

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "measure_seconds": round(self.measure_seconds, 6),
                "entries": len(self._load()), "path": self.path}


_DEFAULT_CACHE: TuningCache | None = None


def default_cache() -> TuningCache:
    """Process-wide cache, made anew when ``$PADDLE_TPU_TUNE_CACHE``
    changes."""
    global _DEFAULT_CACHE
    want = os.environ.get(_CACHE_ENV)
    if _DEFAULT_CACHE is None or (want and _DEFAULT_CACHE.path != want):
        _DEFAULT_CACHE = TuningCache()
    return _DEFAULT_CACHE


def _block_i_candidates(i_size: int):
    """The search space: MLP column chunks that divide the intermediate
    size and are multiples of 8, largest first (the JAX tuner's)."""
    cands = [c for c in (i_size, 1024, 512, 256, 128, 64, 32, 16, 8)
             if c <= i_size and i_size % c == 0 and c % 8 == 0]
    return sorted(set(cands), reverse=True)


def _device_name(dev: torch.device) -> str:
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def cuda_trial(step, args, steps=2, warmup=1) -> float:
    """Seconds per call of ``step(*args)`` on the card: ``warmup`` calls,
    then ``steps`` calls between two CUDA events."""
    for _ in range(warmup):
        step(*args)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(steps):
        step(*args)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / 1e3 / steps


def tune_decode_layer(b, h, h_kv, d, page_size, n_pages, hd, i_size,
                      dtype="bfloat16", quant=None, device=None, cache=None,
                      trial=None, steps=2, warmup=1, kernel_hash=None):
    """Search ``block_i`` for the decode-layer kernel at this serving
    shape; persist and install the winner.

    A cache hit installs the stored ``block_i`` with zero trials. On a miss
    (and with tuning enabled) every candidate runs through ``trial``
    (default :func:`cuda_trial`) on synthetic inputs at the real shapes,
    on ``device``; the entry ``{block_i, ms, timings_ms, ...}`` is
    persisted and the winner installed. Returns the entry, or ``None``
    when tuning is disabled on a miss, or there is no card (and no
    injected trial) or the kernel does not take the shape."""
    cache = cache or default_cache()
    dev = torch.device(device) if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "cpu")
    shapes = ((b, h, d), (n_pages, h_kv, page_size, d), (b, hd),
              (i_size, hd))
    kernel_hash = kernel_hash or _build.lib_path("decode_layer").name
    name = _device_name(dev)
    key = kernel_fingerprint(KERNEL, shapes, (dtype,), device=name,
                             quant=quant, kernel_hash=kernel_hash)
    entry = cache.get(key)
    if entry is not None:
        set_block_override(BLOCK_I_KEY, int(entry["block_i"]))
        return entry
    if not tuning_enabled():
        return None
    tdtype = getattr(torch, dtype)
    if trial is None:
        if dev.type != "cuda" or not use_kernel(
                (b, h, d), (n_pages, h_kv, page_size, d), n_pages, hd,
                i_size, tdtype):
            return None
        trial = cuda_trial

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(tdtype)

    q = randn(b, h, d)
    kl = randn(n_pages, h_kv, page_size, d)
    vl = randn(n_pages, h_kv, page_size, d)
    tab = torch.arange(n_pages, dtype=torch.int32,
                       device=dev)[None].repeat(b, 1)
    pos = torch.full((b,), page_size * n_pages - 1, dtype=torch.int32,
                     device=dev)
    hres = randn(b, hd)
    wo = randn(hd, h * d, scale=0.02)
    wg = randn(i_size, hd, scale=0.02)
    wu = randn(i_size, hd, scale=0.02)
    wd = randn(hd, i_size, scale=0.02)
    norm = torch.ones(hd, dtype=tdtype, device=dev)

    timings = {}
    t0 = time.perf_counter()
    for c in _block_i_candidates(i_size):
        def step(qx, c=c):
            return decode_layer(qx, kl, vl, tab, pos, hres, wo, norm, wg,
                                wu, wd, norm, block_i=c)
        timings[c] = trial(step, (q,), steps=steps, warmup=warmup)
    cache.add_measure_seconds(time.perf_counter() - t0)

    best = min(timings, key=timings.get)
    entry = {
        "kernel": KERNEL, "device": name, "kernel_hash": kernel_hash,
        "block_i": int(best), "ms": timings[best] * 1e3,
        "timings_ms": {str(c): t * 1e3 for c, t in timings.items()},
        "shapes": [list(s) for s in shapes],
        "dtype": str(dtype), "quant": quant,
        "measured_at": time.time(),
    }
    cache.put(key, entry)
    set_block_override(BLOCK_I_KEY, int(best))
    return entry


def tune_for_serving(serving_model, page_size, num_pages, max_pages,
                     max_batch, cache=None, trial=None):
    """Engine hook: derive the decode shape from a bound ``ServingModel``
    and tune (or load from the cache) before the first decode step."""
    m = serving_model
    cfg = m.model.cfg
    dtype = str(m.pool.k.dtype).replace("torch.", "")
    return tune_decode_layer(
        int(max_batch), m.n_head, m.n_kv, m.head_dim, int(page_size),
        int(max_pages), cfg.hidden_size, cfg.intermediate_size, dtype=dtype,
        quant=m._quant_dtype if m.quantized else None,
        device=m.pool.k.device, cache=cache, trial=trial)


def lookup_measured(kernel, device=None, cache=None):
    """Most recent cache entry for a kernel name on a device (by name;
    default: this process's CUDA device). Leaves the counters alone."""
    cache = cache or default_cache()
    if device is None:
        device = _device_name(torch.device("cuda")) \
            if torch.cuda.is_available() else "cpu"
    best = None
    for entry in cache.entries().values():
        if not isinstance(entry, dict):
            continue
        if entry.get("kernel") != kernel or entry.get("device") != device:
            continue
        if best is None or entry.get("measured_at", 0) > \
                best.get("measured_at", 0):
            best = entry
    return best
