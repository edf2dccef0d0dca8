"""Row 18 on Hopper (``paddle_tpu_torch/csrc/softmax_mask.cu``), on the CPU.

What the kernels' launches and arithmetic must keep, checked without a
card:

- the plan (``softmax_mask.plan``): the C kernels' assignment of rows and
  8-element vectors to blocks, groups and lanes, emulated here from the
  kernel's index arithmetic, covers every (row, vector) of the output once;
  the lanes of a register-path row hold all of it; rows past Sk 8192 take
  the shared-memory path; the set of key lengths the card path accepts is
  the parent's (``Sk % 8 == 0``, ``4 Sk`` forward and ``8 Sk`` backward
  bytes within the shared-memory limit);
- the declared launches: the causal example's bytes are x's lower triangle
  (``sum over q of min(q + 1, Sk)``) plus y, at Sq = Sk, Sq > Sk and
  Sq < Sk; its declared reads of x are exactly the live vectors; a sweep
  block reads one mask row, once per (b, q);
- against the JAX package (its Pallas kernels in interpret mode, or its
  composite ``reference_softmax_mask`` where its kernel takes no such mask):
  NaN and inf past the diagonal give exactly 0; the top-left corner when
  Sq != Sk; a row masked wholly to -inf gives NaN; a mask that varies over
  heads beside one that does not. A numpy model of the register kernel's
  row arithmetic (max over the live vectors, ``exp2(x log2 e - max log2
  e)``, one reciprocal, ``exp(-inf - max) / sum`` past the diagonal) is
  held against the JAX kernel on rows with NaN and inf.

Tolerances, as the largest absolute error over the largest reference
magnitude: f32 1e-5 (the same f32 arithmetic in another order, the
exponential in base 2); bf16 2**-7, one bf16 ulp (one rounding, a value
near a boundary may land on the other side). Positions that must be 0 or
NaN are held exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.kernels import _common as kern
from paddle_tpu.ops.kernels import softmax_mask_pallas as jsm
from paddle_tpu_torch.ops.kernels import WRAPPERS
from paddle_tpu_torch.ops.kernels import softmax_mask as sm

TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
KINDS = ("sweep", "sweepb", "mask", "tri", "bwd")
SHAPES = [(2, 3, 5, 8), (1, 4, 7, 64), (2, 2, 9, 1000), (1, 3, 4, 1024),
          (1, 2, 5, 2048), (1, 1, 2, 8192), (1, 1, 3, 16384)]


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    for w in WRAPPERS.values():
        w.launches = 0
    yield
    assert all(w.launches == 0 for w in WRAPPERS.values())


@pytest.fixture
def interpret():
    kern.force_interpret(True)
    try:
        yield
    finally:
        kern.force_interpret(False)


# -- the plan -------------------------------------------------------------------

def _kernel_rows(p, kind, b, h, sq, bx, grp, per):
    """Rows that group ``grp`` of block ``bx`` takes, as the C kernels
    compute them (``softmax_mask_kernel`` / ``softmax_mask_bwd_kernel``)."""
    rows = b * h * sq
    if kind == "sweep":                  # a block (b, q), its heads
        bb, q = divmod(bx, sq)
        r0, step = (bb * h + grp) * sq + q, per * sq
        n = -(-(h - grp) // per) if grp < h else 0
    elif kind == "sweepb":               # a block (h, q), its batches
        hh, q = divmod(bx, sq)
        r0, step = (grp * h + hh) * sq + q, per * h * sq
        n = -(-(b - grp) // per) if grp < b else 0
    elif kind == "tri":                  # a pair (i, Sq - 1 - i)
        pairs = (sq + 1) // 2
        g = bx * per + grp
        if g >= (rows // sq) * pairs:
            return []
        bh, i = divmod(g, pairs)
        return sorted({bh * sq + i, bh * sq + sq - 1 - i})
    else:                                # one row
        r0, step = bx * per + grp, 1
        n = min(1, rows - r0)
    return [r0 + k * step for k in range(max(n, 0))]


def _coverage(kind, b, h, sq, sk):
    """Times each (row, 8-element vector) of the output is written."""
    p = sm.plan(kind, b, h, sq, sk)
    vecs = sk // 8
    count = np.zeros((b * h * sq, vecs), np.int64)
    if p.path == "smem":
        assert p.blocks == b * h * sq
        count += 1                          # a block a row, all of it
        return p, count
    nl = p.lanes * p.warps
    per = 1 if p.warps > 1 else p.threads // p.lanes
    assert per == p.groups
    for bx in range(p.blocks):
        for grp in range(per):
            lanes = np.arange(nl)           # the group's lanes, across warps
            js = (lanes[:, None] + nl * np.arange(p.vpl)[None, :]).ravel()
            js = js[js < vecs]
            for r in _kernel_rows(p, kind, b, h, sq, bx, grp, per):
                np.add.at(count[r], js, 1)
    return p, count


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plan_covers_every_row_once(kind, shape):
    b, h, sq, sk = shape
    p, count = _coverage(kind, b, h, sq, sk)
    assert (count == 1).all(), np.argwhere(count != 1)[:3]
    if p.path == "regs":
        assert p.lanes * p.warps * p.vpl * 8 >= sk
        assert p.vpl in (1, 2, 4) and p.lanes in (1, 2, 4, 8, 16, 32)
        assert p.threads <= 256 and p.threads % 32 == 0
        # the ring: stages x vectors a lane x threads x 16-byte words of x
        # (and of the mask, or of dy), after a sweep's f32 mask row
        words = 2 if kind in ("mask", "bwd") else 1
        fixed = 4 * sk if kind.startswith("sweep") else 0
        assert p.smem == fixed + p.stages * p.vpl * p.threads * 16 * words
        assert p.smem <= 227 * 1024 - 1024
        # two stages (the next row in flight) only where a group takes
        # more than one row; the mask a row and the backward take one, so
        # a group of several warps calls its shared sum once a block there
        most = max(len(_kernel_rows(p, kind, b, h, sq, bx, g, p.groups))
                   for bx in range(p.blocks) for g in range(p.groups))
        assert p.stages == min(2, most)
        if kind in ("mask", "bwd"):
            assert most == 1
        # f32 rows load straight into registers: no ring
        assert sm.plan(kind, b, h, sq, sk, 4, 4).smem == fixed
    else:
        assert sk > sm.REG_MAX_SK
        assert p.smem == (8 if kind == "bwd" else 4) * sk


def test_plan_paths_and_accepted_key_lengths():
    """Every key length the parent accepted is accepted, and no other; the
    register path takes rows up to Sk 8192 within 4 vectors a lane."""
    limit = 227 * 1024 - 1024
    for sk in range(0, 60000, 4):
        for kind, per in (("fwd", 4), ("bwd", 8)):
            assert sm.accepts(sk, kind) == (sk % 8 == 0
                                            and per * sk <= limit), sk
    for sk in range(8, 8 * 7233, 8):
        for kind in KINDS:
            if not sm.accepts(sk, "bwd" if kind == "bwd" else "fwd"):
                continue
            p = sm.plan.__wrapped__(kind, 2, 3, 5, sk)
            if sk <= sm.REG_MAX_SK:
                assert p.path == "regs" and p.warps <= 8
                assert p.lanes * p.warps * p.vpl * 8 >= sk
                # the fewest vectors a lane that hold the row
                assert p.vpl == 1 or p.lanes * p.warps * p.vpl // 2 * 8 < sk
            else:
                assert p.path == "smem" and p.smem <= limit
    assert sm.plan("tri", 8, 12, 1024, 1024)[:5] == ("regs", 32, 1, 4, 128)


def test_c_entries_get_their_argument_lists(monkeypatch):
    """Each launch passes the C entry as many arguments as it declares,
    the plan's whole launch among them (lanes, warps, vectors a lane,
    threads, stages, blocks, shared memory): the C entry launches the grid
    and shared memory that the declarations give. A CUDA tensor would reach
    the same calls."""
    calls = []

    def function(lib, symbol, argtypes):
        def fn(*args):
            calls.append((symbol, len(args), len(argtypes), args))
            return 0
        return fn
    monkeypatch.setattr(sm._build, "function", function)
    x = torch.zeros(2, 3, 5, 64, dtype=torch.bfloat16)
    sm._launch_fwd(x, torch.zeros(2, 1, 5, 64), x, "t", 0)
    sm._launch_fwd(x, torch.zeros(1, 3, 5, 64), x, "t", 0)
    sm._launch_fwd(x, None, x, "t", 0)
    sm._launch_fwd(x, torch.zeros(2, 3, 5, 64), x, "t", 0)
    sm._launch_bwd(x, x, x, 0)
    assert [c[0] for c in calls] == ["ptt_softmax_mask"] * 4 \
        + ["ptt_softmax_mask_bwd"]
    assert all(n == want for _, n, want, _ in calls)
    p = sm.plan("sweep", 2, 3, 5, 64)
    # (mask_f32, mode, mvec, lanes, ..., smem) of a sweep
    assert calls[0][3][12:22] == (1, 0, 1, p.lanes, p.warps, p.vpl,
                                  p.threads, p.stages, p.blocks, p.smem)
    q = sm.plan("bwd", 2, 3, 5, 64)
    assert calls[4][3][6:12] == (q.lanes, q.warps, q.vpl, q.threads,
                                 q.blocks, q.smem)
    assert calls[1][3][13] == 3                  # [1, H]: the batch sweep
    assert calls[2][3][13] == 2                  # causal
    assert calls[3][3][13] == 1                  # [B, H]: a mask a row


# -- the declared launches ------------------------------------------------------

def _keep(sq, sk):
    return np.arange(sk)[None, :] <= np.arange(sq)[:, None]


@pytest.mark.parametrize("sq,sk", [(16, 16), (24, 16), (8, 24), (1000, 1000)])
def test_causal_example_counts_the_triangle(sq, sk):
    ex = sm._ex("t", 1, 2, sq, sk, "tri")
    tri = 2 * int(_keep(sq, sk).sum())
    assert tri == 2 * sm.tri_elements(sq, sk)
    assert ex.nbytes == (tri + 2 * sq * sk) * 2
    assert ex.flops == 6 * tri


@pytest.mark.parametrize("sq,sk", [(16, 16), (24, 16), (9, 40), (3, 1000)])
def test_causal_reads_only_the_live_vectors(sq, sk):
    """The declared reads of x cover each row's first ceil((q + 1) / 8)
    vectors, once, and nothing past them."""
    b, h = 2, 3
    ex = sm._ex("t", b, h, sq, sk, "tri")
    (k,) = ex.kernels
    seen = np.zeros((b * h * sq, sk), np.int64)
    for tm in k.reads:
        assert tm.operand == "x"
        for bid in k.block_ids():
            for t in tm.eval_index(bid):
                seen[tm.element_slices(t)] += 1
    q = np.arange(b * h * sq) % sq
    live = -(-np.minimum(q + 1, sk) // 8) * 8
    want = (np.arange(sk)[None, :] < live[:, None]).astype(np.int64)
    assert (seen == want).all()


def test_sweep_reads_each_mask_row_once():
    b, h, sq, sk = 2, 12, 6, 64
    ex = sm._ex("t", b, h, sq, sk, "mask")
    (k,) = ex.kernels
    (mmap,) = [tm for tm in k.reads if tm.operand == "mask"]
    got = sorted(t for bid in k.block_ids() for t in mmap.eval_index(bid))
    assert got == [(r, 0) for r in range(b * sq)]
    assert k.kernel.startswith("softmax_mask_kernel<__nv_bfloat16,"
                               "__nv_bfloat16,0,")


# -- semantics against the JAX package ------------------------------------------

def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, ref, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else _np(got)
    ref = ref.float().numpy() if isinstance(ref, torch.Tensor) else _np(ref)
    assert got.shape == ref.shape
    assert (np.isnan(got) == np.isnan(ref)).all()
    ok = ~np.isnan(ref)
    err = float(np.abs(got[ok] - ref[ok]).max(initial=0.0))
    assert err <= tol * float(np.abs(ref[ok]).max(initial=0.0)), err


def _both(arr, dtype):
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return jnp.asarray(arr, jd), torch.tensor(arr).to(getattr(torch, dtype))


def _row_model(x, q, mask=None):
    """The register kernel's arithmetic on one f32 row (numpy, f32): max
    over the loaded vectors with fmaxf's NaN rule, ``exp2(fma(v, log2 e,
    -max log2 e))``, one reciprocal of the sum, ``exp2(-inf - max log2 e)
    / sum`` at the columns it does not read."""
    f = np.float32
    sk = x.shape[0]
    n = sk if mask is not None or q is None else -(-min(q + 1, sk) // 8) * 8
    v = x[:n].astype(f) + (mask[:n].astype(f) if mask is not None else f(0))
    if q is not None:
        v = np.where(np.arange(n) > q, f(-np.inf), v)
    mx = np.fmax.reduce(v)                       # fmaxf skips a NaN
    l2e = f(1.4426950408889634)
    with np.errstate(invalid="ignore"):
        mxl = f(mx * l2e)
        e = np.exp2((v.astype(np.float64) * l2e - mxl).astype(f))
        inv = f(1) / e.sum(dtype=f)
        out = np.full(sk, np.exp2(f(-np.inf) - mxl) * inv, f)
    out[:n] = e * inv
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_nan_and_inf_past_the_diagonal_give_zero(interpret, dtype):
    rng = np.random.default_rng(170)
    sq, sk = 16, 40
    x = (rng.standard_normal((2, 2, sq, sk)) * 3).astype(np.float32)
    above = ~_keep(sq, sk)
    junk = np.array([np.nan, np.inf, -np.inf], np.float32)
    x[..., above] = junk[rng.integers(0, 3, size=x[..., above].shape)]
    jx, tx = _both(x, dtype)
    y_j = jsm.softmax_mask_tri(jx, True)
    y_t = sm.softmax_mask_tri(tx)
    for y in (_np(y_j), y_t.float().numpy()):
        assert not np.isnan(y).any()
        assert (y[..., above] == 0).all() and not np.signbit(
            y[..., above]).any()
    _close(y_t, y_j, TOL[dtype])
    xf = _np(jx)
    model = np.stack([_row_model(xf[b, h, q], q) for b in range(2)
                      for h in range(2) for q in range(sq)])
    _close(torch.tensor(model.reshape(x.shape)), y_j, TOL[dtype])


@pytest.mark.parametrize("sq,sk", [(6, 24), (24, 8)])
def test_causal_top_left_corner_when_sq_differs(interpret, sq, sk):
    rng = np.random.default_rng(171)
    x = (rng.standard_normal((1, 3, sq, sk)) * 3).astype(np.float32)
    jx, tx = _both(x, "bfloat16")
    y_j = jsm.softmax_mask_tri(jx, True)
    _close(sm.softmax_mask_tri(tx), y_j, TOL["bfloat16"])
    xf = _np(jx)
    model = np.stack([_row_model(xf[0, h, q], q) for h in range(3)
                      for q in range(sq)])
    _close(torch.tensor(model.reshape(x.shape)), y_j, TOL["bfloat16"])
    if sq > sk:                         # rows past Sk see every column
        assert (_np(y_j)[0, :, sk:] > 0).all()


def test_wholly_masked_and_nan_rows_give_nan_on_both(interpret):
    rng = np.random.default_rng(172)
    x = (rng.standard_normal((2, 3, 8, 16)) * 3).astype(np.float32)
    m = rng.standard_normal((2, 1, 8, 16)).astype(np.float32)
    m[0, 0, 2] = -np.inf                     # batch 0, row 2: wholly masked
    x[1, 1, 5, 3] = np.nan                   # one live NaN: the row is NaN
    y_j = jsm.softmax_mask_fused(jnp.asarray(x), jnp.asarray(m), True)
    y_t = sm.softmax_mask(torch.tensor(x), torch.tensor(m))
    assert np.isnan(_np(y_j)[0, :, 2]).all() and torch.isnan(y_t[0, :, 2]).all()
    assert np.isnan(_np(y_j)[1, 1, 5]).all() and torch.isnan(y_t[1, 1, 5]).all()
    _close(y_t, y_j, TOL["float32"])
    model = np.stack([_row_model(x[b, h, q], None, m[b, 0, q])
                      for b in range(2) for h in range(3) for q in range(8)])
    _close(torch.tensor(model.reshape(x.shape)), y_j, TOL["float32"])
    # causal: a NaN in the live part makes the whole row NaN, past the
    # diagonal too, in the reference and in the model
    xc = x.copy()
    xc[0, 0, 4, 1] = np.nan
    y_c = jsm.softmax_mask_tri(jnp.asarray(xc), True)
    assert np.isnan(_np(y_c)[0, 0, 4]).all()
    assert np.isnan(_row_model(xc[0, 0, 4], 4)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masks_over_heads_and_shared_by_heads(interpret, dtype):
    """A padding mask [B, 1, Sq, Sk] (the sweep over heads) against the JAX
    kernel; a mask [1, H, Sq, Sk] that varies over heads (the sweep over
    batches) and one [B, H, Sq, Sk] (a mask a row) against JAX's composite
    (its kernel folds the head axis and takes no such mask)."""
    rng = np.random.default_rng(173)
    x = (rng.standard_normal((2, 4, 8, 24)) * 3).astype(np.float32)
    pad = np.where(rng.random((2, 1, 8, 24)) < 0.3, -1e4, 0.0
                   ).astype(np.float32)
    per_head = (rng.standard_normal((1, 4, 8, 24)) * 2).astype(np.float32)
    jx, tx = _both(x, dtype)
    jp, tp = _both(pad, dtype)
    jh, th = _both(per_head, dtype)
    y_pad = jsm.softmax_mask_fused(jx, jp, True)
    _close(sm.softmax_mask(tx, tp), y_pad, TOL[dtype])
    _close(sm.softmax_mask(tx, th), jsm.reference_softmax_mask(jx, jh),
           TOL[dtype])
    assert sm._fwd_kind(tx, tp)[0] == "sweep"
    assert sm._fwd_kind(tx, th)[0] == "sweepb"
    full = (rng.standard_normal(x.shape) * 2).astype(np.float32)
    jf, tf = _both(full, dtype)
    assert sm._fwd_kind(tx, tf)[0] == "mask"
    _close(sm.softmax_mask(tx, tf), jsm.reference_softmax_mask(jx, jf),
           TOL[dtype])
