"""Rows 19 and 20 on Hopper (``paddle_tpu_torch/csrc/bias_dropout_ln.cu``,
``csrc/dropout_add.cu``), on the CPU.

What the kernels' launches and arithmetic must keep, checked without a
card:

- the plans: ``bias_dropout_ln.plan``'s assignment of rows and 8-element
  vectors to blocks, groups and lanes, emulated here from the kernels'
  index arithmetic (the forward a block a row, thread j vector j; in the
  backward group g of G walks rows g, g + G, ...; lane q of a group of n
  holds vectors q and, past 768 vectors, q + n), covers every (row,
  vector) once, forward and backward, at small shapes and tails; its
  launch stays within the C entries' checks (``valid_fwd``,
  ``valid_plan``, ``checked``, whose constants are read from the source);
  every hidden width the parent accepted (``H % 8 == 0``, ``H <= 8192``,
  bf16 or f32, with or without a mask) has a plan that fits; the
  backward's partial rows are its blocks, at most one an SM;
  ``dropout_add.grid`` reaches every 8-element chunk once;
- the declared launches: the bytes from the row type's itemsize (bf16 and
  f32), the backward's one partial row of each sum a block, no finding of
  the declaration plane;
- against the JAX package (its Pallas kernels in interpret mode), through
  the port's entry points on the CPU: masked, maskless and the p >= 1 zero
  mask, a row count that is no multiple of a block's groups, a cotangent
  on h; dropout-add at a count that is no multiple of 8.

Tolerances, as the largest absolute error over the largest reference
magnitude: f32 1e-5 (the same f32 arithmetic in another order), bf16
2**-7 (one bf16 ulp: one rounding, a value near a boundary may land on
the other side); the f32 vector gradients 1e-5. Dropped positions are held
exactly.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.kernels import _common as kern
from paddle_tpu.ops.kernels import bias_dropout_ln_pallas as jbdl
from paddle_tpu.ops.kernels import dropout_add_pallas as jda
from paddle_tpu_torch.analysis.kernels.rules import check_example
from paddle_tpu_torch.ops.kernels import WRAPPERS
from paddle_tpu_torch.ops.kernels import bias_dropout_ln as bdl
from paddle_tpu_torch.ops.kernels import dropout_add as da

CSRC = Path(bdl.__file__).resolve().parents[2] / "csrc"
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
#: (rows, hidden): backward lane groups of 1 and 8 lanes, 3 warps, two
#: warps with idle lanes, 16 warps of one and two vectors a lane; one row,
#: fewer rows than a block's groups, more than the grid's with a
#: remainder
SHAPES = [(1, 8), (300, 8), (7, 64), (2200, 768), (37, 776), (2113, 1000),
          (1, 4096), (265, 4096), (3, 8192), (133, 8192)]


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


def _const(src, name):
    """An integer constant of a source (digits, *, +, - only)."""
    text = re.search(rf"constexpr int {name} = ([0-9 *+-]+);", src).group(1)
    return int(eval(text, {"__builtins__": {}}))


# -- the plans ------------------------------------------------------------------

def _coverage(p, rows, hidden):
    """Times each (row, vector) is taken, as the kernels compute it."""
    vecs = hidden // 8
    n = p.lanes * p.warps
    assert p.threads == p.groups * n
    count = np.zeros((rows, vecs), np.int64)
    # lane q holds vectors q, q + n, ... (vpl of them)
    js = (np.arange(n)[:, None] + n * np.arange(p.vpl)[None, :]).ravel()
    js = js[js < vecs]
    stride = p.blocks * p.groups
    for gi in range(stride):             # block gi // groups, group gi % groups
        for r in range(gi, rows, stride):
            np.add.at(count[r], js, 1)
    return count


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("itemsize,masked", [(2, True), (2, False), (4, True)])
@pytest.mark.parametrize("rows,hidden", SHAPES)
def test_plan_covers_every_vector_once(kind, itemsize, masked, rows, hidden):
    p = bdl.plan(kind, rows, hidden, itemsize, masked)
    count = _coverage(p, rows, hidden)
    assert (count == 1).all(), np.argwhere(count != 1)[:3]
    # the forward a block a row; the backward a block an SM at most, no
    # block without a row
    if kind == "fwd":
        assert p.blocks == rows and p.groups == 1
    else:
        assert 1 <= p.blocks <= 132
    assert (p.blocks - 1) * p.groups < rows


def test_plan_within_the_c_entries_checks():
    """The C entries' constants are the wrapper's, and every plan of the
    accepted set passes their checks. Forward: whole warps of one vector a
    thread covering the row, at most 1024 threads, no shared memory.
    Backward: lanes a power of two (whole warps past 32), one vector a lane
    up to 768 vectors and two past it, covering the row, at most 768
    threads (512 at two vectors) of whole groups, at most 15 named
    barriers, shared memory within the opt-in limit."""
    src = (CSRC / "bias_dropout_ln.cu").read_text()
    assert _const(src, "kMaxHidden") == bdl.MAX_HIDDEN == 8192
    assert _const(src, "kSmemMax") == bdl._SMEM
    assert _const(src, "kStages") == bdl._STAGES == 2
    assert "threads <= 1024 && threads * 8 >= hidden" in src
    assert "kMaxThreads = V == 1 ? 768 : 512;" in src
    assert bdl._MAX_THREADS == {1: 768, 2: 512}
    assert "__launch_bounds__(kMaxThreads<V>, 1)" in src
    assert "hidden <= 8 * 768" in src and bdl._ONE_VECTOR_MAX == 768
    for hidden in range(8, bdl.MAX_HIDDEN + 1, 8):
        p = bdl.plan("fwd", 4096, hidden)
        assert (p.lanes, p.vpl, p.groups, p.blocks, p.smem) == \
            (32, 1, 1, 4096, 0)
        assert p.threads == 32 * p.warps <= 1024
        assert p.threads * 8 >= hidden > (p.threads - 32) * 8
        for itemsize, masked in ((2, True), (4, True), (2, False)):
            p = bdl.plan("bwd", 4096, hidden, itemsize, masked)
            n = p.lanes * p.warps
            assert p.lanes in (1, 2, 4, 8, 16, 32)
            assert p.warps == 1 or p.lanes == 32
            assert p.vpl == (1 if hidden <= 8 * 768 else 2)
            assert n * p.vpl * 8 >= hidden > (n // 2) * p.vpl * 8
            assert p.threads % 32 == 0 and p.threads == p.groups * n
            assert 32 <= p.threads <= bdl._MAX_THREADS[p.vpl]
            assert p.warps == 1 or p.groups <= 15
            ring = p.groups * 2 * hidden * (2 * itemsize + 4 * masked)
            comb = 12 * hidden if p.threads > max(32, n) else 0
            assert p.smem == max(ring, comb) + 8 * p.groups * 2 <= bdl._SMEM


def test_plan_of_the_phase3_shapes():
    """Forward: a block of 3 warps a row at H 768, 32 at H 8192. Backward:
    H 768 groups of 3 warps, 8 a block (24 warps an SM); H 4096 16 warps,
    one a block; H 8192 16 warps of two vectors a lane, its f32 ring of two
    masked rows within the shared memory; a handful of rows spread over
    the SMs."""
    assert bdl.plan("fwd", 8192, 768) == (32, 3, 1, 1, 96, 8192, 0)
    assert bdl.plan("fwd", 1024, 8192)[:6] == (32, 32, 1, 1, 1024, 1024)
    assert bdl.plan("bwd", 8192, 768)[:6] == (32, 3, 1, 8, 768, 132)
    assert bdl.plan("bwd", 4096, 768)[:6] == (32, 3, 1, 8, 768, 132)
    assert bdl.plan("bwd", 4096, 4096)[:6] == (32, 16, 1, 1, 512, 132)
    assert bdl.plan("bwd", 1024, 8192)[:5] == (32, 16, 2, 1, 512)
    assert bdl.plan("bwd", 1024, 8192, 4, True).smem == 2 * 8192 * 12 + 16
    assert bdl.plan("bwd", 1, 64)[:6] == (8, 1, 1, 4, 32, 1)


def test_c_argument_lists():
    """The ctypes argument lists match the C entries' parameters."""
    for name, args in (("ptt_bias_dropout_ln", bdl._ARGS),
                       ("ptt_bias_dropout_ln_bwd", bdl._BWD_ARGS)):
        src = (CSRC / "bias_dropout_ln.cu").read_text()
        sig = re.search(rf"{name}\(([^)]*)\)", src).group(1)
        assert len(sig.split(",")) == len(args), name
    src = (CSRC / "dropout_add.cu").read_text()
    sig = re.search(r"ptt_dropout_add\(([^)]*)\)", src).group(1)
    assert len(sig.split(",")) == len(da._ARGS)


@pytest.mark.parametrize("n", [1, 7, 8, 8 * 256 * 3 + 3, 300_003,
                               8192 * 768])
def test_dropout_plan_reaches_every_chunk_once(n):
    blocks = da.grid(n)
    src = (CSRC / "dropout_add.cu").read_text()
    assert _const(src, "kThreads") == da._THREADS == 256
    assert 1 <= blocks <= 132 * 8
    chunks, total = n // 8, blocks * da._THREADS
    taken = np.zeros(chunks, np.int64)
    for t in range(min(total, chunks)):      # thread t: t, t + T, ...
        taken[t::total] += 1
    assert (taken == 1).all()
    per = [len(range(t, chunks, total)) for t in (0, min(total, chunks) - 1)]
    assert max(per) - min(per) <= 1 if chunks else True


# -- the declared launches ------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("masked", [True, False])
def test_declared_bytes_from_the_itemsize(dtype, masked):
    rows, hd = 300, 776
    b = dtype.itemsize
    for bwd in (False, True):
        ex = bdl._ex("x", rows, hd, masked, bwd, dtype)
        want = rows * hd * (4 * b + 4 * masked) + (16 if bwd else 12) * hd
        assert ex.nbytes == want == bdl.declared_bytes(
            "bwd" if bwd else "fwd", rows, hd, b, masked)
    ex = da._ex("x", 37, 1001, False, dtype)
    assert ex.nbytes == 3 * 37 * 1001 * b


def _findings(ex):
    """The declaration plane's findings but the missing tail (CK204: this
    example is one shape of ``ck_examples``' pairs)."""
    return [f for f in check_example(ex) if f.rule_id != "CK204"]


@pytest.mark.parametrize("rows,hd", [(2200, 768), (300, 4096), (37, 64)])
def test_backward_writes_one_partial_row_a_block(rows, hd):
    ex = bdl._ex("x", rows, hd, True, True)
    p = bdl.plan("bwd", rows, hd, 2, True)
    part = ex.operand("part")
    assert part.shape == (3, p.blocks, hd) and p.blocks <= 132
    rows_k, sum_k = ex.kernels
    assert rows_k.grid[0] == p.blocks and rows_k.threads == p.threads
    assert rows_k.smem == p.smem
    assert sum_k.kernel == "bdl_partial_sum_kernel"
    assert _findings(ex) == []
    fwd = bdl._ex("x", rows, hd, True, False)
    # the forward's block a row reads its row and the vectors
    assert {m.operand for m in fwd.kernels[0].reads} == \
        {"x", "res", "mask", "gamma", "bias", "beta"}
    assert _findings(fwd) == []


# -- against the JAX package ------------------------------------------------------

def _both(arr, dtype):
    jd, td = DTYPES[dtype]
    j = jnp.asarray(arr).astype(jd)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)


def _close(got, ref, tol):
    got = got.detach().float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    assert err <= tol * float(np.abs(ref).max()), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [0.25, None, 1.0], ids=["mask", "maskless",
                                                      "zeros"])
def test_bias_dropout_ln_against_jax(interpret, dtype, p):
    """37 rows of H 264 (two vectors a lane, lanes idle; no multiple of a
    block's 16 groups), forward and the vjp with cotangents on y and h."""
    rng = np.random.default_rng(180)
    shape, hd = (37, 264), 264
    x, res, dy, dh = (rng.standard_normal(shape).astype(np.float32)
                      for _ in range(4))
    vecs = [(rng.standard_normal(hd) * 0.1 + s).astype(np.float32)
            for s in (0.0, 1.0, 0.0)]
    mask = None if p is None else (
        np.zeros(shape, np.float32) if p >= 1 else
        ((rng.random(shape) >= p) / (1 - p)).astype(np.float32))
    (jx, tx), (jr, tr), (jdy, tdy), (jdh, tdh) = (
        _both(a, dtype) for a in (x, res, dy, dh))
    jv = [jnp.asarray(v) for v in vecs]
    tv = [torch.tensor(v, requires_grad=True) for v in vecs]
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.tensor(mask)

    def f(a, b, r, g, be):
        return jbdl.bias_dropout_ln(a, b, r, jm, g, be, 1e-5, True)
    (y_j, h_j), vjp = jax.vjp(f, jx, jv[0], jr, jv[1], jv[2])
    dx_j, db_j, dres_j, dg_j, dbe_j = vjp((jdy, jdh))
    tx.requires_grad_()
    tr.requires_grad_()
    y_t, h_t = bdl.BiasDropoutLNFunction.apply(tx, tv[0], tr, tm, tv[1],
                                               tv[2], 1e-5, False)
    torch.autograd.backward((y_t, h_t), (tdy, tdh))
    tol = TOL[dtype]
    _close(y_t, y_j, tol)
    _close(h_t, h_j, tol)
    _close(tx.grad, dx_j, tol)
    _close(tr.grad, dres_j, tol)
    for got, ref in zip(tv, (db_j, dg_j, dbe_j)):
        _close(got.grad, ref, 1e-5)
    if p is not None and p >= 1:
        assert not tx.grad.any()
        np.testing.assert_array_equal(h_t.detach().float().numpy(),
                                      tr.detach().float().numpy())


@pytest.mark.parametrize("dtype,n", [("float32", 7), ("bfloat16", 7),
                                     ("bfloat16", 8 * 256 + 3)])
def test_dropout_add_against_jax(interpret, dtype, n):
    """A count that is no multiple of 8: the same positions dropped as the
    JAX kernel's, forward and vjp."""
    rng = np.random.default_rng(181)
    x = (np.abs(rng.standard_normal(n)) + 1.0).astype(np.float32)
    res = rng.standard_normal(n).astype(np.float32)
    dy = (np.abs(rng.standard_normal(n)) + 1.0).astype(np.float32)
    (jx, tx), (jr, tr), (jdy, tdy) = (_both(a, dtype) for a in (x, res, dy))
    seed, p = 4321, 0.3
    y_j, vjp = jax.vjp(lambda a, r: jda.dropout_add(
        a, r, jnp.asarray(seed, jnp.int32), p, True), jx, jr)
    dx_j, _ = vjp(jdy)
    tx.requires_grad_()
    y_t = da.DropoutAddFunction.apply(tx, tr, seed, p, False)
    y_t.backward(tdy)
    dropped = np.asarray(jnp.asarray(y_j, jnp.float32)) == \
        np.asarray(jnp.asarray(jr, jnp.float32))
    np.testing.assert_array_equal(
        y_t.detach().float().numpy() == tr.float().numpy(), dropped)
    np.testing.assert_array_equal(tx.grad.float().numpy() == 0, dropped)
    _close(y_t, y_j, TOL[dtype])
    _close(tx.grad, dx_j, TOL[dtype])
