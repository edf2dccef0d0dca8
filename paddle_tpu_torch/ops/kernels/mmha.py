"""One-token decode attention over the paged KV pool: CUDA kernel and
plain version.

Replaces ``paddle_tpu/ops/kernels/mmha_pallas.py`` ``mmha_decode`` (:109;
kernel body :53-89). Source: ``paddle_tpu_torch/csrc/mmha.cu``.

The JAX decode path gathers each layer's pages into a contiguous
``[B, Hkv, T, D]`` copy (``serving/kv_cache.py:gather_layer``) and runs the
TPU kernel over it. This kernel reads the pages through the page table
itself, so a step moves only the keys and values each row can see; the
plain version keeps the JAX dataflow: :func:`gather_pages` followed by
the grouped einsum of ``mmha_pallas.reference_mmha`` (:152-170).

What bounds it on the H100: bytes — the visible keys and values, with
about ``4 * rep`` flops per byte. The kernel runs one block of 8 warps per
(kv head, batch row), GQA-native: the ``rep = H / Hkv`` query heads that
share a kv head are loaded once and reuse every key and value row read.
Groups of 8 lanes own one position at a time (1 KB contiguous reads per
warp within a page) with an f32 online softmax each; positions past
``pos[b]`` are never visited, masked scores are -1e30 and the denominator
is clamped at 1e-30, as in the TPU kernel (:75, :85-88). The per-group
states merge by shuffles, then across warps through shared memory.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["mmha_decode", "mmha_plain", "gather_pages", "reference_mmha"]

_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_HEAD_DIMS = (64, 128)
_REPS = (1, 2, 4, 8)


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


def mmha_decode(q, k_pool, v_pool, tables, pos):
    """Decode attention of ``q [B, 1, H, D]`` over one layer's paged pool
    ``k_pool``/``v_pool [P, Hkv, ps, D]`` through ``tables [B, max_pages]``
    int32, row ``b`` seeing positions ``0..pos[b]`` (int32 ``[B]``).
    Returns ``[B, 1, H, D]``. A CPU tensor takes :func:`mmha_plain`; a CUDA
    tensor launches the kernel (bf16, D in {64, 128}, H / Hkv in
    {1, 2, 4, 8}) or raises."""
    _check(q, k_pool, v_pool, tables, pos)
    if q.device.type == "cpu":
        return mmha_plain(q, k_pool, v_pool, tables, pos)
    if q.device.type != "cuda":
        raise ValueError(f"mmha: no kernel for device {q.device}")
    b, _, h, d = q.shape
    _, h_kv, ps, _ = k_pool.shape
    if q.dtype != torch.bfloat16 or k_pool.dtype != torch.bfloat16:
        raise TypeError(f"mmha kernel takes bf16, got {q.dtype} / "
                        f"{k_pool.dtype}")
    if d not in _HEAD_DIMS or h // h_kv not in _REPS:
        raise ValueError(f"mmha kernel takes D in {_HEAD_DIMS} and H/Hkv in "
                         f"{_REPS}, got D={d}, H/Hkv={h // h_kv}")
    ops = (q, k_pool, v_pool, tables, pos)
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("mmha kernel takes contiguous tensors")
    _build.require_aligned("mmha", q, k_pool, v_pool)
    out = torch.empty_like(q)
    _launch(q, k_pool, v_pool, tables, pos, out, _build.stream_of(q))
    mmha_decode.launches += 1
    return out


mmha_decode.launches = 0


def _launch(q, k_pool, v_pool, tables, pos, out, stream):
    """The C entry on operands the caller allocated."""
    b, _, h, d = q.shape
    _, h_kv, ps, _ = k_pool.shape
    fn = _build.function("mmha", "ptt_mmha_paged", _ARGS)
    _build.check(fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                    tables.data_ptr(), pos.data_ptr(), out.data_ptr(), b,
                    h_kv, h // h_kv, d, ps, tables.shape[1], stream), "mmha")


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

def _ex(label, lengths, h, h_kv, d, ps=16, max_pages=128, seed=7):
    """One block of 8 warps a (kv head, row): grid (Hkv, B); the block
    writes the REP query heads of its kv head. The keys and values it
    reads go through the page table (not declared as tiles)."""
    from ._examples import fixed, model
    m = model()
    bf = torch.bfloat16
    b, rep = len(lengths), h // h_kv
    tables, pos, n_pages = paged_tables(lengths, ps, max_pages, seed)
    ops = [m.Operand("q", (b, 1, h, d), bf),
           m.Operand("k", (n_pages, h_kv, ps, d), bf),
           m.Operand("v", (n_pages, h_kv, ps, d), bf),
           m.Operand("tables", tuple(tables.shape), torch.int32,
                     data=fixed(tables)),
           m.Operand("pos", (b,), torch.int32, data=fixed(pos)),
           m.Operand("out", (b, 1, h, d), bf, "out")]
    heads = m.TileMap("out", (1, 1, rep * d), lambda g, r, z: (r, g, 0),
                      view=(b, h_kv, rep * d))
    kern = m.KernelLaunch(
        f"mmha_paged_kernel<{d},{rep}>", (h_kv, b), 256, writes=[heads],
        reads=[m.TileMap("q", heads.block, heads.index, view=heads.view)])

    def plain(t):
        return {"out": mmha_plain(t["q"], t["k"], t["v"], t["tables"],
                                  t["pos"])}

    def launch(t, stream):
        _launch(t["q"], t["k"], t["v"], t["tables"], t["pos"], t["out"],
                stream)

    seen = int((pos + 1).sum())
    return m.Example(label, "mmha", ops, [kern], launch, plain,
                     flops=4 * seen * h * d,
                     nbytes=2 * seen * h_kv * d * 2 + 2 * b * h * d * 2
                     + tables.numel() * 4)


def ck_examples():
    """At ``mmha_pallas.pk_examples``' shape (q [8, 1, 32, 128] over 8 kv
    heads and 2048 positions a row; the JAX cache is contiguous, the
    port's is paged) and phase 3's (the same q at positions 0..1500 with
    an inactive row 0); a tail at D 64, REP 4 and lengths that end inside
    a page and inside a round of the block's 32 position streams."""
    from ._examples import with_tail
    out = []
    for label, lengths in (
            ("mmha_decode", [2048] * 8),
            ("phase3 [8, 1, 32, 128]", [0, 18, 256, 257, 701, 1024, 1201,
                                        1501])):
        out.append(with_tail(_ex, label, dict(lengths=lengths, h=32, h_kv=8,
                                              d=128),
                             dict(lengths=[1, 37, 100], h=8, h_kv=2, d=64)))
    return out
