"""Paged KV cache: fixed-size pages in a preallocated pool (counterpart of
``paddle_tpu/serving/kv_cache.py``).

The pool is one ``[num_layers, num_pages, num_kv_heads, page_size, D]``
tensor each for keys and values, plus a per-request page table
(``[max_pages]`` int32, the physical page of each logical page). Page 0 is
the **trash page**: unallocated table slots point at it, and writes that
must go nowhere (inactive batch rows) land in it. Attention masks by
position, so trash contents never reach a real output.

Unlike the JAX helpers, which return an updated pool, the writes here
update the pool tensors **in place**: the pool is the largest state of the
engine and PyTorch has no need to copy it.

:class:`PagePool` owns the tensors and the accounting. A non-trash page
is in exactly one of three states: **free** (on the LIFO free list),
**used** (refcount >= 1, one reference per page table that maps it; a page
at refcount >= 2 is shared and immutable, and the scheduler copies it
before a write would land there) or **cached** (refcount 0, kept because a
prefix-cache key still names its contents; ``alloc`` reclaims cached pages
LRU-first once the free list is empty). ``free`` is a decref. ``leaked()``
counts referenced pages and ``lost()`` checks that the three states
partition the pool. Every change of state sets the JAX package's gauges
``paddle_tpu_serving_kv_pages{state}`` and
``paddle_tpu_serving_shared_pages``; a failed allocation counts in
``paddle_tpu_serving_page_alloc_failures_total``.
"""

from __future__ import annotations

import math
import threading
from collections import OrderedDict

import torch

from ..observability import metrics as _metrics
from ..ops.kernels import mmha

__all__ = [
    "PagePool", "PagePoolError", "PagePoolExhausted", "PageDoubleFree",
    "TRASH_PAGE", "write_token", "write_prefill", "gather_layer",
    "paged_attention", "chunk_attention",
]

#: physical page id reserved as the write sink for padding / inactive rows
TRASH_PAGE = 0

_PAGES = _metrics.gauge("paddle_tpu_serving_kv_pages",
                        "KV-cache pages by state (free/used/cached/total)")
_SHARED = _metrics.gauge("paddle_tpu_serving_shared_pages",
                         "KV pages mapped by more than one request "
                         "(refcount >= 2)")
_ALLOC_FAIL = _metrics.counter(
    "paddle_tpu_serving_page_alloc_failures_total",
    "page allocations that failed because the pool was exhausted")


class PagePoolError(RuntimeError):
    """Pool accounting violation (double free, freeing an unowned page)."""


class PagePoolExhausted(PagePoolError):
    """No free pages left for an allocation."""


class PageDoubleFree(PagePoolError):
    """A second decref of a page whose refcount already reached zero —
    distinct from freeing a foreign id: the page is one of this pool's,
    but nobody holds a reference to give back."""


class PagePool:
    """Preallocated paged KV pool with thread-safe refcounted accounting.

    ``k``/``v`` are ``[num_layers, num_pages, num_kv_heads, page_size,
    head_dim]`` tensors on ``device``. Page ids come from a LIFO free list
    (recently freed pages are reused first); page 0 (:data:`TRASH_PAGE`)
    is never handed out. Each allocated page carries a refcount; the
    prefix cache shares pages across requests by claiming extra
    references, and keyed pages linger in a reclaimable LRU **cached**
    state at refcount 0 instead of returning to the free list.
    """

    def __init__(self, num_layers: int, num_pages: int, num_kv_heads: int,
                 page_size: int, head_dim: int, dtype=torch.float32,
                 device="cpu"):
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is the "
                             "reserved trash page)")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_layers = int(num_layers)
        self.num_pages = int(num_pages)
        self.num_kv_heads = int(num_kv_heads)
        self.page_size = int(page_size)
        self.head_dim = int(head_dim)
        shape = (self.num_layers, self.num_pages, self.num_kv_heads,
                 self.page_size, self.head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        self._lock = threading.Lock()
        self._free = list(range(self.num_pages - 1, TRASH_PAGE, -1))
        self._ref: dict[int, int] = {}          # page -> refcount (>= 1)
        self._shared = 0                        # pages at refcount >= 2
        self._cached: OrderedDict = OrderedDict()   # page -> key, LRU order
        self._keys: dict[int, bytes] = {}       # page -> retained cache key
        # prefix-cache hook, called (page, key) with the POOL lock held
        # whenever a cached page is reclaimed (its contents die)
        self._reclaim_cb = None
        self._export()

    def set_reclaim_hook(self, cb) -> None:
        """``cb(page, key)`` fires (pool lock held) when a cached page is
        reclaimed for reuse; the prefix cache drops its map entry."""
        with self._lock:
            self._reclaim_cb = cb

    # -- accounting ----------------------------------------------------------

    def _export(self):
        """The page gauges; one branch when metrics are off. Caller holds
        the lock (or owns the pool, at construction)."""
        if not _metrics._state.enabled:
            return
        _PAGES.set(len(self._free), state="free")
        _PAGES.set(len(self._ref), state="used")
        _PAGES.set(len(self._cached), state="cached")
        _PAGES.set(self.allocatable, state="total")
        _SHARED.set(self._shared)

    @property
    def allocatable(self) -> int:
        """Total pages that can ever be handed out (pool minus trash)."""
        return self.num_pages - 1

    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def used_pages(self) -> int:
        """Pages with refcount >= 1."""
        with self._lock:
            return len(self._ref)

    @property
    def cached_pages(self) -> int:
        """Refcount-0 pages retained for the prefix cache (reclaimable)."""
        with self._lock:
            return len(self._cached)

    @property
    def available_pages(self) -> int:
        """Pages an ``alloc`` can satisfy now: free + reclaimable cached."""
        with self._lock:
            return len(self._free) + len(self._cached)

    @property
    def shared_pages(self) -> int:
        """Pages mapped by more than one request (refcount >= 2)."""
        with self._lock:
            return self._shared

    def refcount(self, page: int) -> int:
        with self._lock:
            return self._ref.get(int(page), 0)

    def pages_for(self, length: int) -> int:
        """Pages needed to hold ``length`` token positions."""
        return max(0, math.ceil(int(length) / self.page_size))

    def alloc(self, n: int = 1) -> list[int]:
        """Allocate ``n`` pages at refcount 1; raises
        :class:`PagePoolExhausted` (and allocates nothing) when fewer than
        ``n`` are available. The free list comes first; when it runs dry,
        refcount-0 cached pages are reclaimed LRU-first (their cache
        entries dropped through the reclaim hook). A page with refcount
        >= 1 is never taken."""
        with self._lock:
            if n > len(self._free) + len(self._cached):
                _ALLOC_FAIL.inc()
                raise PagePoolExhausted(
                    f"need {n} page(s), {len(self._free)} free + "
                    f"{len(self._cached)} cached (pool {self.allocatable})")
            pages = []
            for _ in range(n):
                p = self._free.pop() if self._free else \
                    self._reclaim_lru_locked()
                self._ref[p] = 1
                pages.append(p)
            self._export()
            return pages

    def _reclaim_lru_locked(self) -> int:
        """Pop the least recently cached refcount-0 page; its key dies."""
        page, key = self._cached.popitem(last=False)
        self._keys.pop(page, None)
        if self._reclaim_cb is not None:
            self._reclaim_cb(page, key)
        return page

    def _take_ref_locked(self, p: int) -> None:
        if p in self._cached:
            del self._cached[p]
            self._ref[p] = 1
        else:
            self._ref[p] += 1
            if self._ref[p] == 2:
                self._shared += 1

    def incref(self, pages) -> None:
        """Take an extra reference on pages whose contents are valid: live
        pages gain a sharer, cached pages revive to refcount 1. Free or
        unknown ids raise."""
        pages = [int(p) for p in pages]
        with self._lock:
            bad = [p for p in pages
                   if p not in self._ref and p not in self._cached]
            if bad:
                raise PagePoolError(
                    f"incref of page(s) {bad} that are neither live nor "
                    f"cached")
            for p in pages:
                self._take_ref_locked(p)
            self._export()

    def claim_prefix(self, pairs) -> list:
        """Claim the longest verified prefix of ``pairs`` (``(page, key)``
        in chain order): each page must still carry exactly that retained
        key, so a page reclaimed and reused between the cache lookup and
        this claim ends the chain. Claimed pages gain a reference (cached
        ones revive). Returns the claimed page ids."""
        claimed = []
        with self._lock:
            for page, key in pairs:
                page = int(page)
                if self._keys.get(page) != key or not (
                        page in self._cached or page in self._ref):
                    break
                self._take_ref_locked(page)
                claimed.append(page)
            if claimed:
                self._export()
        return claimed

    def retain_keys(self, pairs) -> None:
        """Mark live pages cacheable: ``(page, key)`` pairs record the key
        under which a page lingers (cached state) instead of returning to
        the free list at refcount 0."""
        with self._lock:
            for page, key in pairs:
                page = int(page)
                if page in self._ref:
                    self._keys[page] = key

    def free(self, pages) -> None:
        """Release one reference per page (decref). A page reaching
        refcount 0 returns to the free list, or to the cached state when a
        prefix-cache key is retained for it. A second decref raises
        :class:`PageDoubleFree`, a foreign id (or the trash page)
        :class:`PagePoolError`, and a page listed twice in one call
        :class:`PagePoolError`; each before anything changes."""
        pages = [int(p) for p in pages]
        with self._lock:
            if len(set(pages)) != len(pages):
                dups = sorted({p for p in pages if pages.count(p) > 1})
                raise PagePoolError(
                    f"page(s) {dups} appear more than once in one free() "
                    f"call (double free); pool left untouched")
            zero = [p for p in pages if p not in self._ref
                    and (p in self._cached or p in self._free)]
            if zero:
                raise PageDoubleFree(
                    f"second decref of page(s) {zero}: refcount already "
                    f"zero (page is free/cached); pool left untouched")
            foreign = [p for p in pages if p not in self._ref]
            if foreign:
                raise PagePoolError(
                    f"freeing page(s) {foreign} this pool never allocated "
                    f"(foreign id or trash page); pool left untouched")
            for p in pages:
                self._ref[p] -= 1
                if self._ref[p] == 1:
                    self._shared -= 1
                if self._ref[p] > 0:
                    continue            # still shared: the page stays live
                del self._ref[p]
                key = self._keys.get(p)
                if key is not None:
                    self._cached[p] = key       # MRU end of the LRU
                else:
                    self._free.append(p)
            self._export()

    def copy_page(self, src: int, dst: int) -> None:
        """Copy one physical page's K and V across every layer, in place
        (the copy-on-write data move). The caller holds references on
        both pages."""
        src, dst = int(src), int(dst)
        self.k[:, dst] = self.k[:, src]
        self.v[:, dst] = self.v[:, src]

    def leaked(self) -> int:
        """Pages still referenced: 0 once every request has finished.
        Cached (refcount-0) pages are reclaimable headroom, not leaks."""
        return self.used_pages

    def lost(self) -> int:
        """Pages in no state (free, used or cached): always 0."""
        with self._lock:
            return self.allocatable - len(self._free) - len(self._ref) \
                - len(self._cached)


# -- device-side helpers -----------------------------------------------------

def write_token(pool, layer: int, page_ids, slots, vals) -> None:
    """Scatter one k or v row per batch row into ``pool`` in place.

    pool ``[L, P, Hkv, ps, D]``; ``page_ids``/``slots`` ``[B]`` (physical
    page and in-page slot per row; inactive rows point at the trash page);
    vals ``[B, Hkv, D]``.
    """
    pool[layer][page_ids.long(), :, slots.long()] = vals.to(pool.dtype)


def write_prefill(pool, layer: int, table_row, prompt_len: int, vals,
                  page_size: int) -> None:
    """Scatter a prompt's k or v rows into ``pool`` in place; positions
    ``>= prompt_len`` (padding) are steered into the trash page.

    ``table_row`` ``[max_pages]`` int; vals ``[L_pad, Hkv, D]``.
    """
    t = torch.arange(vals.shape[0], device=vals.device)
    page = torch.where(t < prompt_len, table_row.long()[t // page_size],
                       torch.full_like(t, TRASH_PAGE))
    write_token(pool, layer, page, t % page_size, vals)


def gather_layer(pool, layer: int, tables):
    """One layer's pages assembled into the contiguous
    ``[B, Hkv, max_pages * ps, D]`` view (unallocated slots gather the
    trash page; masked by position). pool ``[L, P, Hkv, ps, D]``; tables
    ``[B, max_pages]``."""
    return mmha.gather_pages(pool[layer], tables)


def chunk_attention(q, k_cache, v_cache, start):
    """Causal attention of a query block against the gathered paged view,
    in f32: key position ``j`` is visible to query ``i`` iff
    ``j <= start + i``.

    q ``[B, C, H, D]`` at absolute positions ``start + [0..C)``;
    k/v_cache ``[B, Hkv, T, D]`` gathered after this block's KV writes;
    ``start`` an int or a ``[B]`` tensor. Returns ``[B, C, H, D]``.
    """
    b, s, h, d = q.shape
    h_kv, t = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, s, h_kv, h // h_kv, d).float()
    logits = torch.einsum("bsgrd,bgtd->bgrst", qg,
                          k_cache.float()) / math.sqrt(d)
    qpos = torch.as_tensor(start, device=q.device).reshape(-1, 1) + \
        torch.arange(s, device=q.device)[None, :]            # [B or 1, C]
    mask = torch.arange(t, device=q.device)[None, None, :] <= \
        qpos[:, :, None]                                     # [B|1, C, T]
    logits = logits.masked_fill(~mask[:, None, None], float("-inf"))
    out = torch.einsum("bgrst,bgtd->bsgrd", torch.softmax(logits, dim=-1),
                       v_cache.float())
    return out.reshape(b, s, h, d).to(q.dtype)


def paged_attention(q, pool: PagePool, layer: int, tables, pos, plain=False):
    """Decode attention of ``q [B, 1, H, D]`` over ``layer`` of the pool,
    row ``b`` seeing positions ``0..pos[b]`` through ``tables``
    ``[B, max_pages]`` int32: the mmha kernel, which reads the pages
    through the table (``plain=True``: gather, then grouped einsum)."""
    fn = mmha.mmha_plain if plain else mmha.mmha_decode
    return fn(q, pool.k[layer], pool.v[layer], tables, pos)
