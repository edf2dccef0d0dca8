"""Prefix cache: cross-request KV page reuse by a rolling token-chain hash
(counterpart of ``paddle_tpu/serving/prefix_cache.py``).

**Keys.** A full KV page is immutable once its ``page_size`` positions are
written, and its contents are a function of the model, the pool dtype, the
page size and the token ids up to and including the page. Each full page
of a context is named by a rolling chain hash::

    h_0 = H(fingerprint || tokens[0 : ps])
    h_i = H(h_{i-1}    || tokens[i*ps : (i+1)*ps])

so page ``i``'s key commits to the whole prefix before it, and a lookup can
only match a page-aligned prefix chain. :func:`model_fingerprint` folds in
what else shapes page contents. The keys are the JAX package's, byte for
byte.

**Lifecycle.** The scheduler inserts a request's full context pages once
its prefill completes (refcount >= 1 while the request runs, the pool's
reclaimable cached state at refcount 0). At admission it claims the
longest cached chain: :meth:`PrefixCache.claim` looks keys up under the
cache lock, then ``PagePool.claim_prefix`` re-verifies that each page still
carries that key while taking a reference, so a page reclaimed and reused
in between ends the chain instead of serving wrong KV. The pool's LRU
reclaim (pool lock held) drops the map entry through :meth:`_evicted`;
the cache never holds its own lock while calling into the pool, so the
lock order is pool, then cache.

Hits and misses count on the cache and in the JAX package's series
``paddle_tpu_serving_prefix_hits_total`` / ``_misses_total``; the gauge
``paddle_tpu_serving_prefix_entries`` follows the map's size.
"""

from __future__ import annotations

import hashlib
import threading

from ..observability import metrics as _metrics

__all__ = ["PrefixCache", "chain_keys", "model_fingerprint"]


_HITS = _metrics.counter("paddle_tpu_serving_prefix_hits_total",
                         "full prompt pages served from the prefix cache")
_MISSES = _metrics.counter("paddle_tpu_serving_prefix_misses_total",
                           "full prompt pages that had to be prefilled")
_ENTRIES = _metrics.gauge("paddle_tpu_serving_prefix_entries",
                          "hash-chain entries resident in the prefix cache")


def chain_keys(fingerprint: bytes, tokens, page_size: int) -> list:
    """Rolling chain hash per full page of ``tokens`` (``len // page_size``
    keys); key ``i`` commits to every token through page ``i``'s end."""
    ps = int(page_size)
    out = []
    h = bytes(fingerprint)
    for i in range(len(tokens) // ps):
        page = tokens[i * ps:(i + 1) * ps]
        blob = h + b"|" + ",".join(str(int(t)) for t in page).encode()
        h = hashlib.blake2b(blob, digest_size=16).digest()
        out.append(h)
    return out


def model_fingerprint(model, quant=None, quant_group_size: int = -1,
                      dtype: str = "float32", page_size: int = 16) -> bytes:
    """Identity of what a KV page's contents depend on besides tokens:
    architecture, quantization, pool dtype and page size. Weights are not
    hashed (the cache is engine-local)."""
    cfg = getattr(model, "cfg", None)
    layers = list(getattr(model, "layers", []) or [])
    fields = (
        type(model).__name__, len(layers),
        getattr(cfg, "num_heads", None), getattr(cfg, "num_kv_heads", None),
        getattr(cfg, "head_dim", None), getattr(cfg, "hidden_size", None),
        getattr(cfg, "vocab_size", None),
        getattr(cfg, "max_position_embeddings", None),
        quant, int(quant_group_size), str(dtype), int(page_size),
    )
    return hashlib.blake2b(repr(fields).encode(), digest_size=16).digest()


class PrefixCache:
    """Hash-chain -> physical-page map over one :class:`~.kv_cache.PagePool`.

    Thread-safe. Eviction is the pool's LRU over refcount-0 cached pages:
    the cache itself never frees a page and never holds one the pool
    thinks is free.
    """

    def __init__(self, pool, fingerprint: bytes):
        self.pool = pool
        self.fingerprint = bytes(fingerprint)
        self._lock = threading.Lock()
        self._map: dict = {}        # chain key -> physical page id
        self.hits_total = 0         # full prompt pages served from the cache
        self.misses_total = 0       # full prompt pages that were prefilled
        pool.set_reclaim_hook(self._evicted)

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)

    def keys_for(self, tokens) -> list:
        """Chain keys for every full page of ``tokens``."""
        return chain_keys(self.fingerprint, tokens, self.pool.page_size)

    def lookup(self, keys) -> list:
        """Longest mapped chain prefix as ``[(page, key), ...]``: map reads
        only; the pool verifies and claims afterwards."""
        pairs = []
        with self._lock:
            for k in keys:
                page = self._map.get(k)
                if page is None:
                    break
                pairs.append((page, k))
        return pairs

    def claim(self, keys) -> list:
        """Claim the longest cached chain for ``keys`` (references taken:
        cached pages revive, live pages gain a sharer). Returns the claimed
        page ids; ``len(claimed) * page_size`` context tokens need no
        prefill."""
        pairs = self.lookup(keys)
        if not pairs:
            return []
        return self.pool.claim_prefix(pairs)

    def insert(self, keys, pages) -> int:
        """Register ``pages`` (the fully written pages of one request's
        context, refcount >= 1) under their chain ``keys``. Keys already
        mapped are skipped: the first writer wins. Returns the number of
        new entries."""
        with self._lock:
            novel = [(int(p), k) for k, p in zip(keys, pages)
                     if k not in self._map]
        if not novel:
            return 0
        # retain first (pool lock), then publish (cache lock), never
        # nested; the inserting request's references keep the pages live
        self.pool.retain_keys(novel)
        n = 0
        with self._lock:
            for p, k in novel:
                if k not in self._map:
                    self._map[k] = p
                    n += 1
            _ENTRIES.set(len(self._map))
        return n

    def _evicted(self, page, key) -> None:
        """Pool reclaim hook (pool lock held): the page's contents are
        about to be overwritten; drop the entry if it still points here."""
        with self._lock:
            if self._map.get(key) == int(page):
                del self._map[key]
            _ENTRIES.set(len(self._map))

    def note_result(self, hit_pages: int, missed_pages: int) -> None:
        """Admission outcome, in pages."""
        with self._lock:
            self.hits_total += int(hit_pages)
            self.misses_total += int(missed_pages)
        if hit_pages:
            _HITS.inc(hit_pages)
        if missed_pages:
            _MISSES.inc(missed_pages)

    def stats(self) -> dict:
        with self._lock:
            out = {"entries": len(self._map), "hits_total": self.hits_total,
                   "misses_total": self.misses_total}
        out["cached_pages"] = self.pool.cached_pages
        out["shared_pages"] = self.pool.shared_pages
        return out
