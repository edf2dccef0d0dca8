"""Rows 3 and 5 on Hopper, the RMSNorm backward and the SwiGLU forward
(``paddle_tpu_torch/csrc/rms_norm.cu``, ``csrc/swiglu.cu``, the shared
``csrc/norm_rows.cuh``), on the CPU.

What the kernels' launches and arithmetic must keep, checked without a
card:

- the RMSNorm backward's plan (``rms_norm.make_bwd`` / ``bwd_plan``),
  emulated here from the kernel's index arithmetic: group q of block b
  walks rows [(b * groups + q) * strip, ... + strip), lane l of warp w of
  a group owns the row's vectors (k * warps + w) * 32 + l, k < 2. Every
  (row, 8-column vector) is written exactly once and every block writes
  its one partial row, at one and three blocks an SM, at hidden 8, 768,
  2048, 4096 and
  8192 (and H + 8 below 8192), at 0 rows, one row, odd tails and more rows
  than a wave; the ring's schedule (kStages stages, a row asked into the
  stage its row kStages earlier held once every warp is past that row's
  reduction) hands each row to the group from the stage and mbarrier phase
  the kernel waits on, never overwriting a stage before it is read; every
  such launch passes the C entry's checks, whose constants and word layout
  are read from the source;
- the SwiGLU forward's plan (``swiglu.make`` / ``plan``): the grid-stride
  loop of U vectors a step covers every vector once and one thread takes
  the n % 8 tail, for n % 8 in 0-7, n < 8 and n = 0, at every unroll;
- both C entries' argument lists against the ctypes lists, and the
  declared launches (names, grids, blocks, shared memory and bytes of the
  plan; no finding of the declaration plane);
- against the JAX package (its Pallas kernels in interpret mode), through
  the port's entry points on the CPU: ``RMSNormFunction``'s dx, dw (and
  the residual's gradient) against ``jax.vjp`` of
  ``rms_norm_pallas.rms_norm_fused``, with and without a residual, and
  ``F.swiglu`` against ``swiglu_pallas.swiglu_fused``, g at +-88, +-100
  and +-1e4 included (and those elements one by one against silu(g) * u
  in f64, within one ulp, or within |g u| 2**-126 where sigmoid(g) leaves
  f32's normal range).

Tolerances, as the largest absolute error over the largest reference
magnitude: f32 1e-5 (the same f32 arithmetic in another order; dw, a sum
over rows in another order, 1e-5 of its largest value too), bf16 2**-7
(one bf16 ulp: one rounding, a value near a boundary may land on the other
side). The JAX backward adds the residual's cotangent after rounding dx,
the port before (``rms_norm.py``'s docstring): in bf16 that is one more
rounding, so bf16 dx is held to two ulps.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.kernels import rms_norm_pallas as jrms
from paddle_tpu.ops.kernels import swiglu_pallas as jsw
from paddle_tpu_torch.analysis.kernels.rules import check_example
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.kernels import WRAPPERS
from paddle_tpu_torch.ops.kernels import rms_norm as rn
from paddle_tpu_torch.ops.kernels import swiglu as sw

CSRC = Path(rn.__file__).resolve().parents[2] / "csrc"
BLOCKS_SM = [1, 3]
HIDDENS = [8, 768, 776, 2048, 2056, 4096, 4104, 8192]
ROWS = [0, 1, 37, 1061, 4096]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2.0 ** -7)}


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    for w in WRAPPERS.values():
        w.launches = 0
    yield
    assert all(w.launches == 0 for w in WRAPPERS.values())


def _consts(name):
    """The ``constexpr int`` constants of a source's top level, evaluated
    (digits, names defined before it, *, +, -, / only)."""
    src = (CSRC / name).read_text()
    raw = dict(re.findall(r"^constexpr int (\w+) = ([^;]+);", src, re.M))
    out = {}
    for k, text in raw.items():
        for _ in range(3):
            text = re.sub(r"[A-Za-z_]\w*", lambda m: f"({raw[m.group(0)]})",
                          text)
        out[k] = int(eval(text.replace("/", "//"), {"__builtins__": {}}))
    return out, src


# -- row 3: the RMSNorm backward's plan ---------------------------------------

def _bwd_decode(word):
    """``bwd_decode`` of rms_norm.cu."""
    return dict(gw=word & 0x1F, ng=(word >> 8) & 0xF,
                strip=(word >> 12) & 0xFFFFF, blocks=(word >> 32) & 0x7FFFFFFF)


def _bwd_valid(w, rows, hidden, has_gh):
    """``bwd_valid`` of rms_norm.cu, with its constants from the source."""
    c, _ = _consts("rms_norm.cu")
    if hidden <= 0 or hidden % 8 or hidden > c["kBwdMaxHidden"] or rows < 0:
        return False
    if not 1 <= w["gw"] <= c["kBwdMaxGroupWarps"]:
        return False
    if 8 * c["kBwdVecs"] * 32 * w["gw"] < hidden:
        return False
    if w["ng"] < 1 or 32 * w["gw"] * w["ng"] > c["kBwdMaxThreads"]:
        return False
    per = w["ng"] * w["strip"]
    if w["strip"] < 1 or w["blocks"] != -(-rows // per):
        return False
    smem = w["ng"] * c["kBwdStages"] * ((2 + has_gh) * hidden * 2 + 8)
    return smem <= c["kBwdSmemMax"]


def _bwd_coverage(p, rows, hidden):
    """Times each (row, vector) is written and each partial row written, as
    the kernel computes it."""
    vecs = hidden // 8
    count = np.zeros((rows, vecs), np.int64)
    parts = np.zeros(p.blocks, np.int64)
    lanes = np.arange(32)
    for b in range(p.blocks):
        parts[b] += 1
        for q in range(p.groups):
            r0 = (b * p.groups + q) * p.strip
            n = max(0, min(rows - r0, p.strip))
            for wig in range(p.group_warps):
                for k in range(rn._BWD_VECS):
                    j = (k * p.group_warps + wig) * 32 + lanes
                    j = j[j < vecs]
                    count[r0:r0 + n, j[:, None]] += 1 if n else 0
    return count, parts


@pytest.mark.parametrize("blocks_sm", BLOCKS_SM)
@pytest.mark.parametrize("hidden", HIDDENS)
@pytest.mark.parametrize("rows", ROWS)
def test_bwd_plan_covers_every_vector_once(blocks_sm, hidden, rows):
    for has_gh in (False, True):
        p = rn.make_bwd(rows, hidden, has_gh, blocks_sm)
        w = _bwd_decode(p.word)
        assert (w["gw"], w["ng"], w["strip"], w["blocks"]) == (
            p.group_warps, p.groups, p.strip, p.blocks)
        assert _bwd_valid(w, rows, hidden, has_gh)
        assert p.threads == 32 * p.group_warps * p.groups
        count, parts = _bwd_coverage(p, rows, hidden)
        assert (count == 1).all(), np.argwhere(count != 1)[:3]
        assert (parts == 1).all()
        # no block without a row
        assert p.blocks == 0 or (p.blocks - 1) * p.groups * p.strip < rows


def test_bwd_plan_refuses_what_the_kernel_cannot_launch():
    """A group short of the row, a strip short of the rows, a block without
    a row, past 512 threads or 8192 columns: the C entry's checks say no."""
    def word(gw, ng, strip, blocks):
        return _bwd_decode(gw | ng << 8 | strip << 12 | blocks << 32)
    assert not _bwd_valid(word(4, 1, 1, 37), 37, 4096, False)
    assert not _bwd_valid(word(8, 1, 1, 36), 37, 4096, False)
    assert not _bwd_valid(word(8, 1, 1, 38), 37, 4096, False)
    assert not _bwd_valid(word(8, 4, 1, 10), 37, 4096, False)
    assert not _bwd_valid(word(8, 1, 0, 37), 37, 4096, False)
    assert not _bwd_valid(word(16, 1, 1, 37), 37, 8200, False)
    assert _bwd_valid(word(8, 1, 1, 37), 37, 4096, False)


@pytest.mark.parametrize("hidden", [8, 768, 2048, 4096, 8192])
@pytest.mark.parametrize("rows", [1, 5, 37, 4096])
def test_ring_schedule_hands_each_row_from_its_stage(hidden, rows):
    """The ring's schedule, as the kernel runs it for each group: rows
    0..kStages-1 asked first, row i + kStages into stage i % kStages once
    row i is reduced; row i waits on stage i % kStages at parity
    (i / kStages) & 1. Each wait finds that stage holding row i after that
    many completions, and no stage is asked again before its row is read."""
    c, _ = _consts("rms_norm.cu")
    stages = c["kBwdStages"]
    p = rn.bwd_plan(rows, hidden, True)
    for n in sorted({min(p.strip, rows), max(0, rows - (p.blocks * p.groups
                                                        - 1) * p.strip)}):
        held = [None] * stages
        done = [0] * stages
        read = [True] * stages

        def issue(r, st):
            assert read[st], (r, st)
            held[st], read[st] = r, False
            done[st] += 1
        for s in range(min(stages, n)):
            issue(s, s)
        for i in range(n):
            st = i % stages
            # the wait at parity (i / kStages) & 1 passes on completion
            # i / kStages + 1 of the stage, which brought row i
            assert held[st] == i and done[st] == i // stages + 1
            read[st] = True
            if i + stages < n:
                issue(i + stages, st)


def test_bwd_plan_of_the_path_shapes():
    """The Llama and Qwen2-MoE train steps' rows: a group a row of 8 (H
    4096) or 4 (H 2048) warps, 256 threads a block, strips that fill the
    card once at one block an SM, one partial row a block."""
    for rows, hidden, gw, ng, strip in ((4096, 4096, 8, 1, 32),
                                        (4096, 2048, 4, 2, 16)):
        for gh in (False, True):
            p = rn.bwd_plan(rows, hidden, gh)
            assert (p.group_warps, p.groups, p.threads) == (gw, ng, 256)
            assert (p.strip, p.blocks) == (strip, -(-rows // (ng * strip)))
            assert p.blocks <= 132


def test_bwd_constants_match_the_source():
    c, src = _consts("rms_norm.cu")
    assert (c["kBwdVecs"], c["kBwdMaxGroupWarps"], c["kBwdBlockWarps"],
            c["kBwdMaxThreads"], c["kBwdStages"], c["kBwdSmemMax"],
            c["kSumRows"]) == (
        rn._BWD_VECS, rn._BWD_MAX_GROUP_WARPS, rn._BWD_BLOCK_WARPS,
        rn._BWD_MAX_THREADS, rn._BWD_STAGES, rn._BWD_SMEM_MAX, rn._SUM_ROWS)
    assert c["kBwdMaxHidden"] == rn._MAX_HIDDEN == 8192
    # the block opts into at most this much (the static scratch beside it)
    assert rn._BWD_SMEM_MAX + 2 * 2 * 16 * 4 <= 227 * 1024
    # the sums are the header's, shared with the block-epilogue backward
    hdr = (CSRC / "norm_rows.cuh").read_text()
    assert "void sum_partial_rows(" in hdr and "void group_sums(" in hdr
    assert "rw::sum_partial_rows<kSumRows>(part, dw," in src
    epi = (CSRC / "block_epilogue.cu").read_text()
    assert "rw::sum_partial_rows<kSumRows>(part, out," in epi


def test_bwd_wrapper_launches_no_library_reduction():
    """dw comes from the C entry's sum kernel: the wrapper sums nothing."""
    import inspect
    src = inspect.getsource(rn.rms_norm_bwd)
    assert ".sum(" not in src and "_launch_bwd(" in src


# -- row 5: the SwiGLU forward's plan ------------------------------------------

def _fwd_coverage(p, n):
    """Times each element is written: thread t of T takes vectors t, t + T,
    ... in steps of U, then single vectors; the thread whose next vector is
    n // 8 takes the tail."""
    n8, t_all = n // 8, p.blocks * p.threads
    count = np.zeros(n, np.int64)
    tails = 0
    for t in range(t_all):
        i = t
        while i + (p.unroll - 1) * t_all < n8 and p.unroll > 1:
            for k in range(p.unroll):
                v = i + k * t_all
                count[8 * v:8 * v + 8] += 1
            i += p.unroll * t_all
        while i < n8:
            count[8 * i:8 * i + 8] += 1
            i += t_all
        if i == n8:
            count[8 * n8:n] += 1
            tails += 1
    return count, tails


@pytest.mark.parametrize("n", [0, 1, 3, 7, 8, 9, 13, 15, 16, 17, 63,
                               2048 + 5, 9 * 1024 + 6])
@pytest.mark.parametrize("config", [None, (256, 4, 1), (128, 1, 1),
                                    (64, 1, 1), (32, 4, 1)])
def test_fwd_plan_covers_every_element_once(n, config):
    p = sw.plan(n) if config is None else sw.make(n, *config)
    if config is not None:
        # a small grid makes the loop take several steps
        p = p._replace(blocks=min(p.blocks, 3))
    count, tails = _fwd_coverage(p, n)
    assert (count == 1).all(), np.argwhere(count != 1)[:3]
    assert tails == 1


def test_fwd_plan_word_and_constants():
    c, src = _consts("swiglu.cu")
    assert (c["kMaxThreads"], c["kMaxUnroll"]) == (sw._MAX_THREADS,
                                                   sw._MAX_UNROLL)
    for n in (1, 8 * 14336, 512 * 14336, 4096 * 14336, 16440 * 1408):
        p = sw.plan(n)
        assert (p.word & 0x7FF, (p.word >> 12) & 0x7,
                (p.word >> 16) & 0x7FFFFFFF) == (p.threads, p.unroll, p.blocks)
        assert p.threads % 32 == 0 and 32 <= p.threads <= c["kMaxThreads"]
        assert p.unroll in (1, c["kMaxUnroll"]) and p.blocks >= 1
    assert sw.plan(8 * 14336).unroll == 1
    assert sw.plan(4096 * 14336)[:3] == (256, 4, 132 * 4)
    assert "if (i == n8)" in src and "blockIdx.x == 0" not in \
        src[src.index("swiglu_kernel("):src.index("ptt_swiglu(")]


# -- both: C argument lists and declared launches ------------------------------

def test_c_argument_lists():
    import ctypes
    for lib, name, args in (("rms_norm", "ptt_rms_norm_bwd", rn._BWD_ARGS),
                            ("swiglu", "ptt_swiglu", sw._ARGS)):
        src = (CSRC / f"{lib}.cu").read_text()
        sig = re.search(rf"{name}\(([^)]*)\)", src).group(1)
        params = [a.strip() for a in sig.split(",")]
        assert len(params) == len(args), name
        assert params[-2] == "long long plan"
        assert args[-2] is ctypes.c_longlong
        for a, t in zip(params, args):
            assert ("*" in a) == (t is ctypes.c_void_p), (name, a)


def test_declared_launches_follow_the_plans():
    for rows, hidden, gh in ((37, 776, True), (300, 2048, False),
                             (8, 4096, True)):
        p = rn.bwd_plan(rows, hidden, gh)
        ex = rn._ex_bwd("x", rows, hidden, gh)
        rows_k, sum_k = ex.kernels
        assert rows_k.kernel == \
            f"rms_norm_bwd_kernel<{'true' if gh else 'false'}>"
        assert rows_k.grid == (p.blocks, 1, 1) and rows_k.threads == p.threads
        assert rows_k.smem == p.smem
        assert sum_k.grid == (-(-hidden // 32), 1, 1)
        assert ex.nbytes == rn.bwd_declared_bytes(rows, hidden, gh) == \
            2 * rows * hidden * (3 + gh) + 4 * hidden
        assert [f for f in check_example(ex) if f.rule_id != "CK204"] == []
    for rows, width in ((8, 14336), (37, 1413)):
        p = sw.plan(rows * width)
        ex = sw._ex("x", rows, width, "fwd")
        (k,) = ex.kernels
        assert k.kernel == f"swiglu_kernel<{p.unroll}>"
        assert k.grid == (p.blocks, 1, 1) and k.threads == p.threads
        assert [f for f in check_example(ex) if f.rule_id != "CK204"] == []


# -- against the JAX package --------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("residual", [False, True])
def test_rms_norm_function_matches_jax_vjp(dtype, residual):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(20 + residual)
    rows, hidden, eps = 37, 256, 1e-5
    x = rng.standard_normal((rows, hidden)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(hidden)).astype(np.float32)
    r = rng.standard_normal((rows, hidden)).astype(np.float32)
    gy = rng.standard_normal((rows, hidden)).astype(np.float32)
    gh = rng.standard_normal((rows, hidden)).astype(np.float32)
    args = [jnp.asarray(x, jdt), jnp.asarray(w, jdt)]
    if residual:
        args.append(jnp.asarray(r, jdt))
        outs, vjp = jax.vjp(
            lambda a, b, c: jrms.rms_norm_fused(a, b, c, eps, True), *args)
        want = vjp((jnp.asarray(gy, jdt), jnp.asarray(gh, jdt)))
    else:
        outs, vjp = jax.vjp(
            lambda a, b: jrms.rms_norm_fused(a, b, None, eps, True)[0], *args)
        want = vjp(jnp.asarray(gy, jdt))
    ins = [torch.tensor(np.asarray(a.astype(jnp.float32))).to(tdt)
           .requires_grad_() for a in args]
    out = rn.RMSNormFunction.apply(ins[0], ins[1], ins[2] if residual else
                                   None, eps, False)
    cots = [torch.tensor(gy).to(tdt)] + ([torch.tensor(gh).to(tdt)]
                                         if residual else [])
    got = torch.autograd.grad(out if residual else (out,), ins, cots)
    # bf16 dx with the cotangent: two roundings on JAX's side (above)
    tols = [tol * (2 if residual and dtype == "bfloat16" else 1), tol,
            tol * (2 if dtype == "bfloat16" else 1)]
    for g, wnt, t in zip(got, want, tols):
        wnt = np.asarray(wnt.astype(jnp.float32))
        err = np.abs(g.float().numpy() - wnt).max()
        assert err <= t * np.abs(wnt).max(), (err, t)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_swiglu_matches_jax_at_the_extremes(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(21)
    g = 3.0 * rng.standard_normal((9, 64)).astype(np.float32)
    g[0, :12] = [88.0, -88.0, 100.0, -100.0, 1e4, -1e4, 0.0, -87.5, -88.5,
                 -89.0, 20.0, -20.0]
    u = rng.standard_normal((9, 64)).astype(np.float32)
    want = np.asarray(jsw.swiglu_fused(jnp.asarray(g, jdt),
                                       jnp.asarray(u, jdt), True)
                      .astype(jnp.float32))
    got = F.swiglu(torch.tensor(g).to(tdt), torch.tensor(u).to(tdt))
    got = got.float().numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
    # the extremes' row on its own, element by element, against silu(g) * u
    # in f64: within one ulp of each element's own magnitude (2**-133 in
    # bf16's denormal range, 2**-149 in f32's), or, where sigmoid(g) falls
    # below f32's smallest normal (g below about -87.3, where exp(-g) nears
    # f32's largest value and then overflows), within |g u| 2**-126: there
    # sigmoid may come out as 0 (torch's and the kernel's reciprocal of an
    # infinite exp(-g); JAX's CPU kernels flush its denormals as well).
    floor = 2.0 ** (-133 if dtype == "bfloat16" else -149)
    mant = 7 if dtype == "bfloat16" else 23
    gq = torch.tensor(g[0, :12]).to(tdt).double().numpy()
    uq = torch.tensor(u[0, :12]).to(tdt).double().numpy()
    with np.errstate(over="ignore"):        # exp(1e4) is inf: sigmoid 0
        ref = gq / (1.0 + np.exp(-gq)) * uq
    ulp = np.maximum(2.0 ** (np.floor(np.log2(np.abs(ref) + 1e-300)) - mant),
                     floor)
    ulp = np.maximum(ulp, np.abs(gq * uq) * 2.0 ** -126)
    assert (np.abs(got[0, :12] - ref) <= ulp).all(), (got[0, :12], ref)
