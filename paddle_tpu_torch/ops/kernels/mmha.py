"""One-token decode attention over the paged KV pool or a contiguous
cache: CUDA kernel and plain version.

Replaces ``paddle_tpu/ops/kernels/mmha_pallas.py`` ``mmha_decode`` (:109;
kernel body :53-89). Source: ``paddle_tpu_torch/csrc/mmha.cu``.

The kernel loads page ``page_id`` of kv head ``g`` from ``pool + page_id *
page_stride + g * head_stride``. :func:`mmha_decode` passes the pool's
strides; :func:`mmha_decode_contiguous` passes a contiguous ``[B, Hkv, T,
D]`` buffer's (``ps * D``, ``T * D``) with a table whose row ``b`` names
pages ``b * Hkv * (T / ps) + j`` (:func:`contiguous_table`), so the same
kernel reads a caller's cache (``fused_multi_transformer``'s ``[2, B, H,
T, D]``) in place, with no gather and no copy.

The JAX decode path gathers each layer's pages into a contiguous
``[B, Hkv, T, D]`` copy (``serving/kv_cache.py:gather_layer``) and runs the
TPU kernel over it. This kernel reads the pages through the page table
itself, so a step moves only the keys and values each row can see; the
plain version keeps the JAX dataflow: :func:`gather_pages` followed by
the grouped einsum of ``mmha_pallas.reference_mmha`` (:152-170).

What bounds it on the H100: bytes — the visible keys and values, with
about ``4 * rep`` flops per byte. The kernel splits each (batch row, kv
head) over chunks of whole pages (flash-decoding), a block a chunk:
:func:`plan` sizes a chunk at 32 KB of K and V from host-known shapes
alone (no host sync: ``pos`` stays on the device), and a block
whose chunk starts past ``pos[b]`` exits at once. A block brings its
chunk's visible K and V rows into shared memory with one bulk
asynchronous copy a page each, all issued before its first score, and
computes the scores, the chunk's softmax and P V there for the ``rep = H
/ Hkv`` query heads that share the kv head. A row of one chunk writes
its output; otherwise each chunk writes its (max, sum, accumulator) to
its own slot of a scratch buffer and the last block of the row to arrive
(a counter a (row, kv head), cleared again by that block) merges them in
chunk order, so two calls give the same bits. Masked scores are never
formed (the chunk ends at ``pos[b]``) and the denominator is clamped at
1e-30, as in the TPU kernel (:75, :85-88).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

__all__ = ["mmha_decode", "mmha_decode_contiguous", "mmha_plain",
           "gather_pages", "reference_mmha", "contiguous_table", "plan",
           "chunk_spans", "smem_bytes", "rep_block"]

_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + \
    [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
_HEAD_DIMS = (64, 128)
#: the query-group sizes the source instantiates (``REP``)
_REPS = (1, 2, 4, 8)
_THREADS = 256
#: bytes of K and V a chunk (a block) holds, and the source's ``kMaxPages``
_CHUNK_BYTES = 32 * 1024
_MAX_PAGES = 16
#: the source's ``kMaxSmem``: dynamic shared memory a block may ask for
_MAX_SMEM = 200 * 1024
#: positions a page of a contiguous cache (its T must be a multiple)
CONTIGUOUS_PAGE = 16


@functools.lru_cache(maxsize=256)
def plan(b, h_kv, max_pages, page_size, head_dim):
    """``(chunk_pages, n_chunks)`` of the kernel's grid ``(Hkv, B,
    n_chunks)``, from host-known shapes only: a chunk (a block) is the
    whole pages that fit 32 KB of K and V (16 at most, one at least), 64
    positions at D 128 and 128 at D 64 with pages of 16, at any batch. (A
    sweep of 1-16 pages a chunk, and of chunks a block sized to hold the
    grid near 2048 or 528 blocks, found this fastest at B 1, 8 and 16;
    ``PERF.md``.)"""
    cp = min(_MAX_PAGES, max(1, _CHUNK_BYTES // (4 * head_dim * page_size)))
    return cp, -(-max_pages // cp)


def chunk_spans(pos, max_pages, page_size, chunk_pages):
    """The blocks of one (row, kv head) that do work, as the source computes
    them: ``[(chunk, first position, positions), ...]`` for a row whose
    last visible position is ``pos`` (clamped to the table's capacity)."""
    chunk = chunk_pages * page_size
    last = min(int(pos), max_pages * page_size - 1)
    return [(c, c * chunk, min(chunk, last + 1 - c * chunk))
            for c in range(last // chunk + 1)]


def rep_block(rep):
    """``(REP, n_sub)``: the instantiated query-group size that takes
    ``rep = H / Hkv`` query heads a kv head (the next power of two up to 8,
    then 8; the source's ``rep_block``) and the blocks a kv head (``ceil(rep
    / REP)``). Rows past ``rep`` load no q and write nothing, so every rep
    that divides H runs, as the TPU kernel takes every such ratio (it pads
    its query group to a multiple of 8, ``mmha_pallas.py:118-119``). At rep
    == REP the source launches its exact instantiation (every row live)."""
    blk = next(r for r in _REPS if r >= min(rep, _REPS[-1]))
    return blk, -(-rep // blk)


def smem_bytes(head_dim, rep, chunk_pages, page_size):
    """Dynamic shared memory of a block (the source's ``smem_bytes``): K
    and V of the chunk in bf16, the scores of its ``REP`` query rows in
    f32."""
    n = chunk_pages * page_size
    return 4 * n * head_dim + 4 * rep_block(rep)[0] * n


def scratch_floats(b, h_kv, rep, head_dim, n_chunks):
    """f32 scratch of the chunks' partials: each chunk's accumulators and
    its (max, sum) a query row of each block."""
    blk, n_sub = rep_block(rep)
    return b * h_kv * n_sub * n_chunks * blk * (head_dim + 2)


@functools.lru_cache(maxsize=256)
def _layout(b, h_kv, rep, head_dim, page_size, max_pages):
    """``(chunk_pages, scratch floats)`` of a call, or None where a chunk
    does not fit a block's shared memory (one lookup a call on the host)."""
    cp, n_chunks = plan(b, h_kv, max_pages, page_size, head_dim)
    if smem_bytes(head_dim, rep, cp, page_size) > _MAX_SMEM:
        return None
    return cp, scratch_floats(b, h_kv, rep, head_dim, n_chunks)


#: (device index, stream) -> [counters, scratch]: the counters (one a (row,
#: kv head)) are zeroed once and left zero by every call (the block that
#: merges a row clears its counter); the partials' scratch is reused, its
#: calls being ordered on their stream. One pair a stream, so that calls on
#: two streams never share one.
_WORK: dict = {}


def _workspace(device, stream, counters, floats):
    key = (device.index, stream)
    work = _WORK.get(key)
    if work is None:
        work = _WORK[key] = [None, None]
    if work[0] is None or work[0].numel() < counters:
        work[0] = torch.zeros(max(counters, 1024), dtype=torch.int32,
                              device=device)
    if work[1] is None or work[1].numel() < floats:
        work[1] = torch.empty(max(floats, 1 << 16), dtype=torch.float32,
                              device=device)
    return work


def _check(q, k_pool, v_pool, tables, pos):
    if not q.is_floating_point() or k_pool.dtype != v_pool.dtype:
        raise TypeError(f"mmha: q {q.dtype}, k {k_pool.dtype}, v "
                        f"{v_pool.dtype}")
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"mmha takes one query token, q [B, 1, H, D]; got "
                         f"{tuple(q.shape)}")
    b, _, h, d = q.shape
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape \
            or k_pool.shape[3] != d or h % k_pool.shape[1]:
        raise ValueError(f"mmha: pool {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} does not fit q "
                         f"{tuple(q.shape)} (want [P, Hkv, ps, D], H % Hkv "
                         f"== 0)")
    if tables.dim() != 2 or tables.shape[0] != b or pos.shape != (b,):
        raise ValueError(f"mmha: tables {tuple(tables.shape)} / pos "
                         f"{tuple(pos.shape)} must be [B, max_pages] / [B]")
    if tables.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("mmha: tables and pos must be int32")
    if any(t.device != q.device for t in (k_pool, v_pool, tables, pos)):
        raise ValueError("mmha: operands on different devices")


def gather_pages(pool_layer, tables):
    """One layer's pages ``[P, Hkv, ps, D]`` assembled through the page
    table into the contiguous ``[B, Hkv, max_pages * ps, D]`` view."""
    kp = pool_layer[tables.long()]                # [B, Pmax, Hkv, ps, D]
    b, pmax, h, ps, d = kp.shape
    return kp.permute(0, 2, 1, 3, 4).reshape(b, h, pmax * ps, d)


def reference_mmha(q, k_buf, v_buf, pos):
    """Grouped-einsum decode attention over a contiguous ``[B, Hkv, T, D]``
    cache with a ``<= pos`` mask, in f32 (``mmha_pallas.reference_mmha``)."""
    b, s, h, d = q.shape
    h_kv, t = k_buf.shape[1], k_buf.shape[2]
    qg = q.reshape(b, s, h_kv, h // h_kv, d).float()
    logits = torch.einsum("bsgrd,bgtd->bgrst", qg, k_buf.float()) / math.sqrt(d)
    mask = torch.arange(t, device=q.device)[None, :] <= \
        pos.reshape(-1, 1).to(q.device)
    logits = logits.masked_fill(~mask[:, None, None, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrst,bgtd->bsgrd", probs, v_buf.float())
    return out.reshape(b, s, h, d).to(q.dtype)


def mmha_plain(q, k_pool, v_pool, tables, pos):
    """The same function in plain PyTorch: gather, then grouped einsum."""
    _check(q, k_pool, v_pool, tables, pos)
    return reference_mmha(q, gather_pages(k_pool, tables),
                          gather_pages(v_pool, tables), pos)


def _require_kernel(q, k, h_kv, ops):
    """The kernel's own limits on a CUDA call, raised before launching."""
    if q.device.type != "cuda":
        raise ValueError(f"mmha: no kernel for device {q.device}")
    _, _, h, d = q.shape
    if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16:
        raise TypeError(f"mmha kernel takes bf16, got {q.dtype} / "
                        f"{k.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"mmha kernel takes D in {_HEAD_DIMS}, got D={d}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("mmha kernel takes contiguous tensors")


def _run(q, k, v, tables, pos, h_kv, ps, strides):
    """Launch the kernel over ``tables [B, max_pages]`` with the page
    strides ``(page_stride, head_stride)``; one launch counted."""
    b, _, h, d = q.shape
    layout = _layout(b, h_kv, h // h_kv, d, ps, tables.shape[1])
    if layout is None:
        raise ValueError(f"mmha kernel: a page of {ps} positions at D {d} "
                         f"does not fit a block's shared memory")
    cp, floats = layout
    _build.require_aligned("mmha", q, k, v)
    out = torch.empty_like(q)
    stream = _build.stream_of(q)
    ctrl, part = _workspace(q.device, stream,
                            b * h_kv * rep_block(h // h_kv)[1], floats)
    _launch(q, k, v, tables, pos, out, part, ctrl, cp, stream, h_kv, ps,
            strides)
    mmha_decode.launches += 1
    return out


def mmha_decode(q, k_pool, v_pool, tables, pos):
    """Decode attention of ``q [B, 1, H, D]`` over one layer's paged pool
    ``k_pool``/``v_pool [P, Hkv, ps, D]`` through ``tables [B, max_pages]``
    int32, row ``b`` seeing positions ``0..pos[b]`` (int32 ``[B]``).
    Returns ``[B, 1, H, D]``. A CPU tensor takes :func:`mmha_plain`; a CUDA
    tensor launches the kernel (bf16, D in {64, 128}, any H / Hkv) or
    raises. ``mmha_decode.launches`` counts the kernel's
    launches from both entries."""
    _check(q, k_pool, v_pool, tables, pos)
    if q.device.type == "cpu":
        return mmha_plain(q, k_pool, v_pool, tables, pos)
    _, h_kv, ps, d = k_pool.shape
    _require_kernel(q, k_pool, h_kv, (q, k_pool, v_pool, tables, pos))
    return _run(q, k_pool, v_pool, tables, pos, h_kv, ps,
                (h_kv * ps * d, ps * d))


mmha_decode.launches = 0


def contiguous_table(b, h_kv, t, device, ps=CONTIGUOUS_PAGE):
    """The page table that maps a contiguous ``[B, Hkv, T, D]`` cache onto
    the kernel's pages of ``ps`` positions: row ``b``, page ``j`` is page
    ``b * Hkv * (T / ps) + j``, made on ``device`` once a shape (no host
    copy)."""
    return _contiguous_table(torch.device(device), b, h_kv, t, ps)


@functools.lru_cache(maxsize=64)
def _contiguous_table(device, b, h_kv, t, ps):
    n = t // ps
    return (torch.arange(b, dtype=torch.int32, device=device)[:, None]
            * (h_kv * n)
            + torch.arange(n, dtype=torch.int32, device=device)[None, :])


def _check_contiguous(q, k_buf, v_buf, pos):
    if not q.is_floating_point() or k_buf.dtype != v_buf.dtype:
        raise TypeError(f"mmha: q {q.dtype}, k {k_buf.dtype}, v "
                        f"{v_buf.dtype}")
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"mmha takes one query token, q [B, 1, H, D]; got "
                         f"{tuple(q.shape)}")
    b, _, h, d = q.shape
    if k_buf.dim() != 4 or k_buf.shape != v_buf.shape \
            or k_buf.shape[0] != b or k_buf.shape[3] != d \
            or h % k_buf.shape[1]:
        raise ValueError(f"mmha: cache {tuple(k_buf.shape)} / "
                         f"{tuple(v_buf.shape)} does not fit q "
                         f"{tuple(q.shape)} (want [B, Hkv, T, D], H % Hkv "
                         f"== 0)")
    if pos.shape != (b,) or pos.dtype != torch.int32:
        raise ValueError(f"mmha: pos must be int32 [B], got {pos.dtype} "
                         f"{tuple(pos.shape)}")
    if any(t.device != q.device for t in (k_buf, v_buf, pos)):
        raise ValueError("mmha: operands on different devices")


def mmha_decode_contiguous(q, k_buf, v_buf, pos):
    """Decode attention of ``q [B, 1, H, D]`` over a contiguous cache
    ``k_buf``/``v_buf [B, Hkv, T, D]`` (positions ``0..pos[b]`` of row
    ``b``, int32 ``[B]`` on q's device), read in place. A CPU tensor takes
    :func:`reference_mmha`; a CUDA tensor launches the kernel (bf16, D in
    {64, 128}, any H / Hkv, ``T % 16 == 0``) or raises. The
    JAX gate (``mmha_pallas.use_kernel``) sends shapes it refuses to the
    composite; this entry raises instead."""
    _check_contiguous(q, k_buf, v_buf, pos)
    if q.device.type == "cpu":
        return reference_mmha(q, k_buf, v_buf, pos)
    b, h_kv, t, d = k_buf.shape
    ps = CONTIGUOUS_PAGE
    if t % ps:
        raise ValueError(f"mmha kernel takes a contiguous cache of T % {ps} "
                         f"== 0 positions, got T={t}")
    _require_kernel(q, k_buf, h_kv, (q, k_buf, v_buf, pos))
    return _run(q, k_buf, v_buf, contiguous_table(b, h_kv, t, q.device), pos,
                h_kv, ps, (ps * d, t * d))


def _launch(q, k, v, tables, pos, out, part, ctrl, chunk_pages, stream,
            h_kv, ps, strides):
    """The C entry on operands the caller allocated (``part``: the
    scratch; ``ctrl``: at least ``B * Hkv * n_sub`` zero counters, n_sub of
    :func:`rep_block`); ``strides`` is
    ``(page_stride, head_stride)`` in elements."""
    b, _, h, d = q.shape
    fn = _build.function("mmha", "ptt_mmha_paged", _ARGS)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
                    part.data_ptr(), ctrl.data_ptr(), b, h_kv, h // h_kv, d,
                    ps, tables.shape[1], chunk_pages, *strides, stream),
                 "mmha")


def paged_tables(lengths, page_size, max_pages, seed):
    """Page tables that hand out shuffled pages, on the CPU: row r holds
    ``lengths[r]`` positions (0: an inactive row, position 0 and an
    all-trash table). Returns ``(tables [B, max_pages] int32, pos [B]
    int32, n_pages)``; page 0 is the trash page."""
    need = [-(-n // page_size) for n in lengths]
    n_pages = 1 + sum(need)
    perm = (torch.randperm(n_pages - 1, generator=torch.Generator()
                           .manual_seed(seed)) + 1).tolist()
    tables = torch.zeros(len(lengths), max_pages, dtype=torch.int32)
    nxt = 0
    for row, k in enumerate(need):
        tables[row, :k] = torch.tensor(perm[nxt:nxt + k], dtype=torch.int32)
        nxt += k
    pos = torch.tensor([max(n - 1, 0) for n in lengths], dtype=torch.int32)
    return tables, pos, n_pages


# -- declared launches for the kernel analyzer -------------------------------

def _ex(label, lengths, h, h_kv, d, ps=16, max_pages=128, seed=7, t=None):
    """Grid (Hkv, B, chunks) of 256 threads (:func:`plan`): block (g, b, c)
    reads q's REP heads of kv head g and the pages of chunk c through the
    table (not declared as tiles). Which block writes a row's output
    depends on the data (the last chunk of the row to finish, or its only
    one), so the writes of out and of the scratch are left to the guard
    plane (writes=None). The counters go in zero and come out zero. With
    ``t``, the contiguous entry's launch: k and v ``[B, Hkv, t, D]`` read in
    place through :func:`contiguous_table` (pages of 16), every row seeing
    at least one position; otherwise a pool with shuffled pages."""
    from ._examples import fixed, model
    m = model()
    bf = torch.bfloat16
    b, rep = len(lengths), h // h_kv
    if t is None:
        tables, pos, n_pages = paged_tables(lengths, ps, max_pages, seed)
        kv_shape, strides = (n_pages, h_kv, ps, d), (h_kv * ps * d, ps * d)

        def plain(x):
            return {"out": mmha_plain(x["q"], x["k"], x["v"], x["tables"],
                                      x["pos"])}
    else:
        ps, max_pages = CONTIGUOUS_PAGE, t // CONTIGUOUS_PAGE
        tables = contiguous_table(b, h_kv, t, "cpu")
        pos = torch.tensor([n - 1 for n in lengths], dtype=torch.int32)
        kv_shape, strides = (b, h_kv, t, d), (ps * d, t * d)

        def plain(x):
            return {"out": reference_mmha(x["q"], x["k"], x["v"], x["pos"])}
    cp, n_chunks = plan(b, h_kv, max_pages, ps, d)
    blk, n_sub = rep_block(rep)
    if n_sub > 1 and rep % blk:
        raise ValueError(f"mmha example: rep {rep} over blocks of {blk} has a "
                         f"partial block; declare it at a rep of 8 or less, "
                         f"or a multiple of 8")
    zeros = torch.zeros(b * h_kv * n_sub, dtype=torch.int32)
    ops = [m.Operand("q", (b, 1, h, d), bf),
           m.Operand("k", kv_shape, bf), m.Operand("v", kv_shape, bf),
           m.Operand("tables", tuple(tables.shape), torch.int32,
                     data=fixed(tables)),
           m.Operand("pos", (b,), torch.int32, data=fixed(pos)),
           m.Operand("out", (b, 1, h, d), bf, "out"),
           m.Operand("part", (scratch_floats(b, h_kv, rep, d, n_chunks),),
                     torch.float32, "out"),
           m.Operand("ctrl", (b * h_kv * n_sub,), torch.int32,
                     data=fixed(zeros))]
    # block x reads rows x % n_sub * REP .. of kv head x // n_sub: with one
    # block a kv head, the rep rows of head g (REP - rep rows load nothing)
    rows = rep if n_sub == 1 else blk
    exact = "true" if rep == blk else "false"
    kern = m.KernelLaunch(
        f"mmha_paged_kernel<{d},{blk},{exact}>", (h_kv * n_sub, b, n_chunks),
        _THREADS,
        smem=smem_bytes(d, rep, cp, ps), writes=None,
        reads=[m.TileMap("q", (1, 1, rows * d), lambda g, r, z: (r, g, 0),
                         view=(b, h_kv * n_sub, rows * d))])

    def launch(x, stream):
        _launch(x["q"], x["k"], x["v"], x["tables"], x["pos"], x["out"],
                x["part"], x["ctrl"], cp, stream, h_kv, ps, strides)

    seen = int((pos + 1).sum())
    return m.Example(label, "mmha", ops, [kern], launch, plain,
                     flops=4 * seen * h * d,
                     nbytes=2 * seen * h_kv * d * 2 + 2 * b * h * d * 2
                     + tables.numel() * 4)


#: the contiguous row of phase 3 at ``fused_multi_transformer``'s decode
#: shape in chip_smoke's fmt phase (GPT-2 small's heads, B 8, a 1024-position
#: cache, the last step's position 575): (label, lengths, H, Hkv, D, T)
CONTIGUOUS_ROW = ("phase3 contiguous [8, 1, 12, 64] T 1024 pos 575",
                  [576] * 8, 12, 12, 64, 1024)

#: phase 3's rows beside the decode shape: (label, lengths, H, Hkv, D)
PHASE3_ROWS = (
    ("phase3 B 1 pos 900", [901], 32, 8, 128),
    ("phase3 B 16", [0, 18, 256, 257, 701, 1024, 1201, 1501] * 2, 32, 8, 128),
    ("phase3 rep 1", [0] + [100 + 190 * r for r in range(1, 8)], 32, 32, 128),
    ("phase3 rep 8", [0, 18, 256, 257, 701, 1024, 1201, 1501], 64, 8, 128),
    ("phase3 D 64", [0, 18, 256, 257, 701, 1024, 1201, 1501], 32, 8, 64),
    ("phase3 rep 5 (ERNIE)", [0, 18, 256, 257, 701, 1024, 1201, 1501], 20, 4,
     128))


def ck_examples():
    """At ``mmha_pallas.pk_examples``' shape (q [8, 1, 32, 128] over 8 kv
    heads and 2048 positions a row; the JAX cache is contiguous, the
    port's is paged), phase 3's decode shape (the same q at positions
    0..1500 with an inactive row 0) and its rows at B 1, B 16, rep 1 (Hkv
    32), rep 8 (H 64), D 64 and ERNIE-4.5's rep 5 (H 20 / Hkv 4, REP 8 with
    three rows that load nothing; :data:`PHASE3_ROWS`); tails at D 64, REP
    4 (for rep 1, 5 and 8 their own rep) and lengths of one position, two
    ending inside a page (one of them over three chunks, so merged) and
    one on a chunk's edge. Then the contiguous entry at
    :data:`CONTIGUOUS_ROW`, its tail the same lengths over a 320-position
    cache."""
    from ._examples import with_tail
    tail = dict(lengths=[1, 37, 300, 256], h=8, h_kv=2, d=64)
    out = []
    for label, lengths in (
            ("mmha_decode", [2048] * 8),
            ("phase3 [8, 1, 32, 128]", [0, 18, 256, 257, 701, 1024, 1201,
                                        1501])):
        out.append(with_tail(_ex, label, dict(lengths=lengths, h=32, h_kv=8,
                                              d=128), tail))
    for label, lengths, h, h_kv, d in PHASE3_ROWS:
        rep_tail = dict(tail, h=2 * (h // h_kv), h_kv=2) \
            if h // h_kv in (1, 5, 8) else tail
        out.append(with_tail(_ex, label, dict(lengths=lengths, h=h, h_kv=h_kv,
                                              d=d), rep_tail))
    label, lengths, h, h_kv, d, t = CONTIGUOUS_ROW
    out.append(with_tail(_ex, label,
                         dict(lengths=lengths, h=h, h_kv=h_kv, d=d, t=t),
                         dict(tail, t=320)))
    return out
