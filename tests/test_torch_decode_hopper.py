"""Decode attention (row 1, ``csrc/mmha.cu``) and RoPE (row 4,
``csrc/rope.cu``) on Hopper, as far as the CPU can hold them.

- mmha's chunk plan (``mmha.plan`` / ``mmha.chunk_spans``, the source's
  own arithmetic): the live blocks of a row cover every visible position
  exactly once and no other, for an inactive row, one position, a row
  ending inside a page, one ending on a chunk's edge, one filling the
  table and one past it; a chunk is the most whole pages within 32 KB of
  K and V and fits a block's shared memory; the constants are the
  source's.
- Split-and-merge: a plain f32 emulation of the kernel's algorithm (each
  chunk's max, sum and accumulator, merged in chunk order with the
  denominator clamped at 1e-30) on caches gathered from the same pages,
  held against the JAX kernel ``mmha_pallas.mmha_decode(interpret=True)``
  and ``reference_mmha`` at two chunk sizes, and against the port's plain
  version. Tolerance 1e-5 (absolute and relative): f32 on both sides, the
  sums over the positions in another order and split at other places.
- RoPE of q and k: forward and ``jax.vjp`` of both tensors against the JAX
  kernel ``rope_pallas.rope_apply(interpret=True)`` (what the JAX
  ``F.rope`` calls for q and for k), with ``[S, D]`` and per-token tables;
  tolerance 1e-5 (f32 on both sides, products and sums in another order).
  The sign-flag backward equals the rotation by ``-sin`` bit for bit (the
  negation is exact), and ``F.rope`` makes one call of the q+k entry
  forward and one backward, handing the backward the forward's own ``sin``.
- The declared launches: every element of RoPE's outputs written by one
  block; mmha's grid, shared memory and scratch are the plan's.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``).
"""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from paddle_tpu.ops.kernels import mmha_pallas, rope_pallas
from paddle_tpu.serving import kv_cache as jax_kv
from paddle_tpu_torch.cost_model import device_preset
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.kernels import WRAPPERS, mmha, rope

TOL = dict(rtol=1e-5, atol=1e-5)
CSRC = Path(mmha.__file__).resolve().parents[2] / "csrc"


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    """A CPU tensor takes the plain version: no kernel launch is counted."""
    for w in WRAPPERS.values():
        w.launches = 0
    yield
    assert not any(w.launches for w in WRAPPERS.values())


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# -- mmha: the chunk plan ------------------------------------------------------

#: (B, Hkv, max_pages, page size, D): the serving path's decode batches,
#: rep 1's 32 kv heads, D 64, small tables and a page larger than a chunk's
#: byte budget
PLANS = [(8, 8, 128, 16, 128), (1, 8, 128, 16, 128), (16, 8, 128, 16, 128),
         (8, 32, 128, 16, 128), (8, 8, 128, 16, 64), (3, 2, 8, 16, 64),
         (2, 1, 5, 8, 128), (1, 1, 4, 256, 128)]


@pytest.mark.parametrize("b,h_kv,max_pages,ps,d", PLANS)
def test_mmha_plan_fits_the_grid_and_the_block(b, h_kv, max_pages, ps, d):
    cp, n_chunks = mmha.plan(b, h_kv, max_pages, ps, d)
    assert 1 <= cp <= mmha._MAX_PAGES and n_chunks == math.ceil(max_pages / cp)
    # a chunk: the most whole pages within 32 KB of K and V (one at least)
    assert 4 * cp * ps * d <= mmha._CHUNK_BYTES or cp == 1
    assert 4 * (cp + 1) * ps * d > mmha._CHUNK_BYTES or cp == mmha._MAX_PAGES
    assert mmha.smem_bytes(d, 8, cp, ps) <= mmha._MAX_SMEM
    assert n_chunks <= 65535


def test_mmha_plan_at_the_path_shapes():
    """Phase 3's rows: chunks of 4 pages (64 positions) at D 128 and 8 (128
    positions) at D 64, whatever the batch: 32 chunks a row at D 128."""
    for b, h_kv in ((8, 8), (1, 8), (16, 8), (8, 32)):
        assert mmha.plan(b, h_kv, 128, 16, 128) == (4, 32)
    assert mmha.plan(8, 8, 128, 16, 64) == (8, 16)


@pytest.mark.parametrize("b,h_kv,max_pages,ps,d", PLANS)
@pytest.mark.parametrize("length", ["inactive", "one", "inside a page",
                                    "chunk edge", "whole table", "past it"])
def test_mmha_chunks_cover_each_visible_position_once(b, h_kv, max_pages, ps,
                                                      d, length):
    cp, n_chunks = mmha.plan(b, h_kv, max_pages, ps, d)
    chunk, cap = cp * ps, max_pages * ps
    pos = {"inactive": 0, "one": 0, "inside a page": min(ps + ps // 2, cap) - 1,
           "chunk edge": min(2 * chunk, cap) - 1, "whole table": cap - 1,
           "past it": cap + 5}[length]
    spans = mmha.chunk_spans(pos, max_pages, ps, cp)
    seen = np.zeros(cap + 8, np.int32)
    for c, first, n in spans:
        assert 0 <= c < n_chunks and first == c * chunk and 1 <= n <= chunk
        seen[first:first + n] += 1
    visible = min(pos, cap - 1) + 1
    assert (seen[:visible] == 1).all() and not seen[visible:].any()
    # chunks in order; the blocks past the row start past it and exit
    assert [c for c, _, _ in spans] == list(range(len(spans)))
    assert len(spans) * chunk >= visible > (len(spans) - 1) * chunk


def test_mmha_constants_match_the_source():
    src = (CSRC / "mmha.cu").read_text()
    consts = {m.group(1): m.group(2) for m in
              re.finditer(r"constexpr int (k\w+) = ([^;]+);", src)}
    assert consts["kThreads"] == str(mmha._THREADS) == "256"
    assert consts["kMaxSmem"] == "200 * 1024" and mmha._MAX_SMEM == 200 * 1024
    assert consts["kMaxPages"] == str(mmha._MAX_PAGES)
    assert "return 4 * n * d + 4 * rep * n;" in src
    assert mmha.smem_bytes(128, 4, 4, 16) == 4 * 64 * 128 + 4 * 4 * 64
    # the chunk's pages arrive by bulk copies on mbarriers; the only atomic
    # is the integer counter of a (row, kv head)
    assert src.count("hp::bulk_load(") == 2 and "mbar_wait" in src
    assert not re.findall(r"atomic\w+\(", src)
    assert re.findall(r"atom\.[\w.]+", src) == ["atom.add.acq_rel.gpu.global.u32"]
    assert "count_in(&ctrl[bg])" in src
    assert "ctrl[bg] = 0u" in src
    # the merge reads the slots in chunk order
    assert "for (int j = 0; j < n_live; ++j) {" in src


# -- mmha: split and merge against the JAX kernel ------------------------------

def _merge(parts):
    """(sum, accumulator) of chunk partials merged in chunk order as the
    kernel merges them: the running max, and the sum and accumulator
    rescaled by exp(old max - new max) at each chunk."""
    mx, l, acc = np.float32(-1e30), np.float32(0), np.float32(0)
    for m, lc, ac in parts:
        m_new = np.maximum(mx, m)
        w_old, w = np.exp(mx - m_new), np.exp(m - m_new)
        l = l * w_old + lc * w
        acc = acc * w_old[..., None] + ac * w[..., None]
        mx = m_new
    return l, acc


def _split_merge(q, kc, vc, pos, max_pages, ps, cp):
    """The kernel's algorithm in f32 over the gathered cache ``[B, Hkv, T,
    D]``: per chunk the scores of the rep query heads, their max, the sum
    of exp(s - max) and exp(s - max) V; a row of one chunk writes acc /
    max(sum, 1e-30), more merge their chunks in chunk order."""
    b, _, h, d = q.shape
    h_kv = kc.shape[1]
    rep = h // h_kv
    out = np.zeros_like(q)
    for row in range(b):
        spans = mmha.chunk_spans(int(pos[row]), max_pages, ps, cp)
        for g in range(h_kv):
            qg = q[row, 0, g * rep:(g + 1) * rep] * np.float32(1 / math.sqrt(d))
            parts = []
            for _, first, n in spans:
                s = qg @ kc[row, g, first:first + n].T          # [rep, n]
                m = s.max(axis=1)
                p = np.exp(s - m[:, None])
                parts.append((m, p.sum(axis=1), p @ vc[row, g, first:first + n]))
            l, acc = parts[0][1:] if len(parts) == 1 else _merge(parts)
            out[row, 0, g * rep:(g + 1) * rep] = acc / np.maximum(
                l, np.float32(1e-30))[:, None]
    return out


def _paged_case(rng, lengths, h_kv, ps, d, max_pages):
    """A pool whose pages are handed out shuffled; a row of length 0 is
    inactive (all-trash table, pos 0)."""
    tables, pos, n_pages = mmha.paged_tables(lengths, ps, max_pages,
                                             seed=len(lengths))
    pool_k = _rand(rng, 1, n_pages, h_kv, ps, d)
    pool_v = _rand(rng, 1, n_pages, h_kv, ps, d)
    return pool_k, pool_v, tables.numpy(), pos.numpy()


@pytest.mark.parametrize("cp", [1, 4])
def test_split_and_merge_matches_the_jax_kernel(cp):
    """B 3, H 8 / Hkv 2, D 64, pages of 16: rows of an inactive slot, 37
    and 100 positions, at one page a chunk (7 chunks for the longest row)
    and four (two chunks)."""
    rng = np.random.default_rng(cp)
    lengths, h, h_kv, d, ps, max_pages = [0, 37, 100], 8, 2, 64, 16, 8
    pool_k, pool_v, tables, pos = _paged_case(rng, lengths, h_kv, ps, d,
                                              max_pages)
    q = _rand(rng, len(lengths), 1, h, d)
    kc = jax_kv.gather_layer(jnp.asarray(pool_k), 0, jnp.asarray(tables))
    vc = jax_kv.gather_layer(jnp.asarray(pool_v), 0, jnp.asarray(tables))
    got = _split_merge(q, np.asarray(kc), np.asarray(vc), pos, max_pages, ps,
                       cp)
    assert np.isfinite(got).all()
    want = mmha_pallas.mmha_decode(jnp.asarray(q), kc, vc, jnp.asarray(pos),
                                   interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    ref = mmha_pallas.reference_mmha(jnp.asarray(q), kc, vc, jnp.asarray(pos))
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    plain = mmha.mmha_decode(torch.from_numpy(q), torch.from_numpy(pool_k[0]),
                             torch.from_numpy(pool_v[0]),
                             torch.from_numpy(tables), torch.from_numpy(pos))
    np.testing.assert_allclose(got, plain.numpy(), **TOL)


def test_mmha_examples_follow_the_plan():
    for ex in mmha.ck_examples():
        for e in (ex, ex.tail):
            (k,) = e.kernels
            q = e.operand("q")
            b, h, d = q.shape[0], q.shape[2], q.shape[3]
            _, h_kv, ps, _ = e.operand("k").shape
            max_pages = e.operand("tables").shape[1]
            if "contiguous" in e.label:     # k [B, Hkv, T, D], pages of 16
                ps = ps // max_pages
                assert ps == mmha.CONTIGUOUS_PAGE
            cp, n_chunks = mmha.plan(b, h_kv, max_pages, ps, d)
            blk, n_sub = mmha.rep_block(h // h_kv)
            assert k.grid == (h_kv * n_sub, b, n_chunks) and k.threads == 256
            assert k.smem == mmha.smem_bytes(d, h // h_kv, cp, ps) == \
                4 * cp * ps * (d + blk)
            exact = "true" if h // h_kv == blk else "false"
            assert k.kernel == f"mmha_paged_kernel<{d},{blk},{exact}>"
            assert e.operand("part").numel == b * h_kv * n_sub * n_chunks \
                * blk * (d + 2)
            assert k.smem + 4800 <= device_preset()["smem_per_block_optin"]
    labels = {ex.label for ex in mmha.ck_examples()}
    assert {"phase3 B 1 pos 900", "phase3 B 16", "phase3 rep 1",
            "phase3 rep 8", "phase3 D 64", "phase3 rep 5 (ERNIE)"} <= labels


@pytest.mark.parametrize("what", ["f32", "D 96", "H % Hkv", "page 1024",
                                  "strided"])
def test_mmha_kernel_checks_raise(what):
    with FakeTensorMode():
        bf = torch.bfloat16
        d, rep, ps = {"D 96": 96}.get(what, 64), 2, \
            1024 if what == "page 1024" else 16
        e = lambda *s, dt=bf: torch.empty(*s, dtype=dt, device="cuda")  # noqa: E731
        # every H / Hkv runs; 5 query heads over 2 kv heads do not divide
        q, kp = e(2, 1, 5 if what == "H % Hkv" else 2 * rep, d), \
            e(5, 2, ps, d)
        tables, pos = e(2, 4, dt=torch.int32), e(2, dt=torch.int32)
        err = ValueError
        if what == "f32":
            q, kp, err = q.float(), kp.float(), TypeError
        if what == "strided":
            kp = e(5, 2, d, ps).transpose(2, 3)
        with pytest.raises(err):
            mmha.mmha_decode(q, kp, kp, tables, pos)


# -- RoPE of q and k ------------------------------------------------------------

def _tables(rng, rows, d):
    ang = rng.uniform(0, 6.3, (rows, d // 2))
    ang = np.concatenate([ang, ang], axis=-1)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _jax_rope(x, cos, sin, per_token):
    """The JAX kernel on one tensor; per-token tables run a batch row at a
    time (the TPU kernel takes one row a position)."""
    b, s = x.shape[:2]
    if not per_token:
        return np.asarray(rope_pallas.rope_apply(
            jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin), True))
    return np.concatenate([np.asarray(rope_pallas.rope_apply(
        jnp.asarray(x[r:r + 1]), jnp.asarray(cos[r * s:(r + 1) * s]),
        jnp.asarray(sin[r * s:(r + 1) * s]), True)) for r in range(b)])


def _jax_rope_vjp(x, dy, cos, sin, per_token):
    b, s = x.shape[:2]
    rows = [(slice(None), slice(None))] if not per_token else \
        [(slice(r, r + 1), slice(r * s, (r + 1) * s)) for r in range(b)]
    out = []
    for xs, ts in rows:
        _, vjp = jax.vjp(lambda a: rope_pallas.rope_apply(
            a, jnp.asarray(cos[ts]), jnp.asarray(sin[ts]), True),
            jnp.asarray(x[xs]))
        out.append(np.asarray(vjp(jnp.asarray(dy[xs]))[0]))
    return np.concatenate(out)


ROPE_CASES = [((2, 5, 4, 16), 2, False), ((1, 13, 4, 32), 1, False),
              ((3, 1, 8, 16), 2, True), ((2, 3, 4, 68), 2, True)]


@pytest.mark.parametrize("shape,hk,per_token", ROPE_CASES)
def test_rope_qk_matches_the_jax_kernel(shape, hk, per_token):
    rng = np.random.default_rng(sum(shape) + hk)
    b, s, _, d = shape
    q, k = _rand(rng, *shape), _rand(rng, b, s, hk, d)
    cos, sin = _tables(rng, b * s if per_token else s, d)
    ct, st = torch.from_numpy(cos), torch.from_numpy(sin)
    gq, gk = rope.rope_qk(torch.from_numpy(q), torch.from_numpy(k), ct, st)
    np.testing.assert_allclose(gq.numpy(), _jax_rope(q, cos, sin, per_token),
                               **TOL)
    np.testing.assert_allclose(gk.numpy(), _jax_rope(k, cos, sin, per_token),
                               **TOL)
    fq, fk = F.rope(torch.from_numpy(q), torch.from_numpy(k), st, ct)
    assert torch.equal(fq, gq) and torch.equal(fk, gk)


@pytest.mark.parametrize("shape,hk,per_token", ROPE_CASES)
def test_rope_qk_vjp_matches_the_jax_kernel(shape, hk, per_token):
    rng = np.random.default_rng(sum(shape) + 7 * hk)
    b, s, _, d = shape
    q, k = _rand(rng, *shape), _rand(rng, b, s, hk, d)
    dq, dk = _rand(rng, *shape), _rand(rng, b, s, hk, d)
    cos, sin = _tables(rng, b * s if per_token else s, d)
    qt = torch.tensor(q, requires_grad=True)
    kt = torch.tensor(k, requires_grad=True)
    oq, ok = F.rope(qt, kt, torch.from_numpy(sin), torch.from_numpy(cos))
    torch.autograd.backward((oq, ok), (torch.from_numpy(dq),
                                       torch.from_numpy(dk)))
    np.testing.assert_allclose(qt.grad.numpy(),
                               _jax_rope_vjp(q, dq, cos, sin, per_token),
                               **TOL)
    np.testing.assert_allclose(kt.grad.numpy(),
                               _jax_rope_vjp(k, dk, cos, sin, per_token),
                               **TOL)


@pytest.mark.parametrize("per_token", [False, True])
def test_rope_sign_flag_is_rotation_by_minus_sin(per_token):
    rng = np.random.default_rng(11 + per_token)
    b, s, d = 2, 6, 32
    q, k = torch.from_numpy(_rand(rng, b, s, 4, d)), \
        torch.from_numpy(_rand(rng, b, s, 2, d))
    cos, sin = (torch.from_numpy(t) for t in
                _tables(rng, b * s if per_token else s, d))
    gq, gk = rope.rope_qk(q, k, cos, sin, inverse=True)
    nq, nk = rope.rope_qk(q, k, cos, -sin)
    assert torch.equal(gq, nq) and torch.equal(gk, nk)
    # the inverse undoes the rotation
    fq, fk = rope.rope_qk(q, k, cos, sin)
    back = rope.rope_qk(fq, fk, cos, sin, inverse=True)
    torch.testing.assert_close(back[0], q, **TOL)
    torch.testing.assert_close(back[1], k, **TOL)


def test_f_rope_is_one_call_forward_and_one_backward(monkeypatch):
    """q and k go through the q+k entry together: one call forward, one
    backward with ``inverse`` and the forward's own sin table (no -sin
    tensor is built)."""
    calls = []
    real = rope.rope_qk

    def spy(q, k, cos, sin, inverse=False):
        calls.append((tuple(q.shape), None if k is None else tuple(k.shape),
                      inverse, sin))
        return real(q, k, cos, sin, inverse)

    monkeypatch.setattr(rope, "rope_qk", spy)
    rng = np.random.default_rng(3)
    q = torch.tensor(_rand(rng, 2, 3, 4, 16), requires_grad=True)
    k = torch.tensor(_rand(rng, 2, 3, 2, 16), requires_grad=True)
    cos, sin = (torch.from_numpy(t) for t in _tables(rng, 3, 16))
    oq, ok = F.rope(q, k, sin, cos)
    assert [c[:3] for c in calls] == [((2, 3, 4, 16), (2, 3, 2, 16), False)]
    (oq.sum() + 2 * ok.sum()).backward()
    assert [c[:3] for c in calls[1:]] == [((2, 3, 4, 16), (2, 3, 2, 16),
                                           True)]
    assert all(c[3].data_ptr() == sin.data_ptr() and torch.equal(c[3], sin)
               for c in calls)
    with torch.no_grad():
        F.rope(q, k, sin, cos)
    assert len(calls) == 3


def _tile_counts(kernel, tile_map):
    c = np.zeros(tile_map.nblocks, np.int32)
    for blk in kernel.block_ids():
        for t in tile_map.eval_index(blk):
            c[t] += 1
    return c


@pytest.mark.parametrize("label", [
    "phase3 q [8, 1, 32, 128] + k [8, 1, 8, 128]",
    "phase3 q [1, 512, 32, 128] + k [1, 512, 8, 128]"])
def test_rope_pair_examples_write_each_element_once(label):
    """The q+k launch: block j's threads [128 j, 128 (j + 1)) over each
    token's q heads then k heads; every element of both outputs by one
    block, at the path shape (head-row tiles) and its tail (D 68: a
    thread's chunks, heads straddling blocks)."""
    ex = next(e for e in rope.ck_examples() if e.label == label)
    for e in (ex, ex.tail):
        (k,) = e.kernels
        assert {m.operand for m in k.writes} == {"q_out", "k_out"}
        for m in k.writes:
            c = _tile_counts(k, m)
            assert c.min() == 1 and c.max() == 1, (e.label, m.operand)
        threads = k.blocks * 128
        q, kk = e.operand("q").shape, e.operand("k").shape
        d = q[3]
        vec = 8 if (d // 2) % 8 == 0 else 2
        need = q[0] * q[1] * (q[2] + kk[2]) * (d // 2 // vec)
        assert threads - 128 < need <= threads
