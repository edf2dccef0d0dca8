"""Rows 2 and 9 on Hopper, the RMSNorm forward and the block-epilogue
forward (``paddle_tpu_torch/csrc/rms_norm.cu``, ``csrc/block_epilogue.cu``,
their shared ``csrc/norm_rows.cuh``), on the CPU.

What the kernels' launches and arithmetic must keep, checked without a
card:

- the plans: both arms of ``_norm_rows.make`` (a block a row in
  registers, the shared-memory arm), emulated here from the kernels' index
  arithmetic (block b takes row b; thread t holds vector t where 8 t <
  hidden, or in the wide arm vectors t, t + threads, ...), cover every
  (row, vector) exactly once at hidden 768, 2048, 4096 and 8192, each also
  at H + 8, and at row counts of one, a decode batch, an odd tail and more
  rows than a wave; every such launch passes the C entries' checks
  (``valid`` and ``decode`` in ``norm_rows.cuh``, whose constants and word
  layout are read from the source); the shapes and variants the paths
  launch get the arm the measurements chose;
- the C entries' argument lists against the ctypes lists, and the
  epilogue's dispatch, which has a block a row in registers only for the
  variants without an activation or dropout;
- the declared launches: the bytes, the grid, block, arm and shared
  memory of the plan, no finding of the declaration plane;
- against the JAX package (its Pallas kernels in interpret mode), through
  the port's entry points on the CPU: RMSNorm with and without the
  residual in f32 and bf16, and the block epilogue at every act, norm,
  bias and dropout combination in bf16, with the dropped positions held
  exactly.

Tolerances, as the largest absolute error over the largest reference
magnitude: f32 1e-5 (the same f32 arithmetic in another order), bf16
2**-7 (one bf16 ulp: one rounding, a value near a boundary may land on the
other side).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.kernels import block_fused_pallas as jbf
from paddle_tpu.ops.kernels import rms_norm_pallas as jrms
from paddle_tpu_torch.analysis.kernels.rules import check_example
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.kernels import WRAPPERS
from paddle_tpu_torch.ops.kernels import _norm_rows as nr
from paddle_tpu_torch.ops.kernels import block_epilogue as be
from paddle_tpu_torch.ops.kernels import rms_norm as rn

CSRC = Path(rn.__file__).resolve().parents[2] / "csrc"
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ARMS = [nr.ROW, nr.WIDE]
ARM_IDS = ["row", "wide"]
HIDDENS = [768, 776, 2048, 2056, 4096, 4104, 8192]
ROWS = [1, 8, 37, 1061]


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    for w in WRAPPERS.values():
        w.launches = 0
    yield
    assert all(w.launches == 0 for w in WRAPPERS.values())


def _header():
    return (CSRC / "norm_rows.cuh").read_text()


def _const(src, name):
    """An integer constant of a source (digits, names defined before it,
    *, +, -, / only)."""
    text = re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)
    names = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", src))
    for _ in range(3):
        text = re.sub(r"[A-Za-z_]\w*", lambda m: f"({names[m.group(0)]})",
                      text)
    return int(eval(text.replace("/", "//"), {"__builtins__": {}}))


def _valid(p, rows, hidden):
    """``valid`` of norm_rows.cuh, with its constants from the source."""
    src = _header()
    if hidden <= 0 or hidden % 8 or rows <= 0 or p.blocks != rows:
        return False
    if not (32 <= p.threads <= _const(src, "kMaxThreads")
            and p.threads % 32 == 0):
        return False
    if p.arm == nr.ROW:
        return hidden <= _const(src, "kRegHidden") and 8 * p.threads >= hidden
    return p.arm == nr.WIDE and hidden <= _const(src, "kWideHidden")


def _coverage(p, rows, hidden):
    """Times each (row, vector) is written, as the kernels compute it:
    block b row b; thread t vector t (the wide arm: i = 8 t; i += 8
    threads)."""
    vecs = hidden // 8
    count = np.zeros((rows, vecs), np.int64)
    t = np.arange(p.threads)
    if p.arm == nr.WIDE:
        lanes = np.concatenate([np.arange(q, vecs, p.threads) for q in t])
    else:
        lanes = t[t * 8 < hidden]
    rs = np.arange(p.blocks)
    np.add.at(count, (rs[:, None], lanes[None, :]), 1)
    return count


@pytest.mark.parametrize("arm", ARMS, ids=ARM_IDS)
@pytest.mark.parametrize("hidden", HIDDENS)
@pytest.mark.parametrize("rows", ROWS)
def test_every_arm_covers_every_vector_once(arm, hidden, rows):
    p = nr.make(arm, rows, hidden)
    assert _valid(p, rows, hidden)
    count = _coverage(p, rows, hidden)
    assert (count == 1).all(), np.argwhere(count != 1)[:3]
    # the fewest whole warps that give each vector a thread (the wide arm:
    # at most 1024)
    want = max(32, -(-(hidden // 8) // 32) * 32)
    assert p.threads == (min(want, 1024) if arm == nr.WIDE else want)


@pytest.mark.parametrize("rows", ROWS)
def test_past_8192_only_the_wide_arm(rows):
    """H 8200 (8192 + 8): a block a row in registers is refused, the wide
    arm's threads stride over the row."""
    assert not _valid(nr.make(nr.ROW, rows, 8200), rows, 8200)
    p = nr.plan(rows, 8200)
    assert p.arm == nr.WIDE and _valid(p, rows, 8200)
    assert (_coverage(p, rows, 8200) == 1).all()


def test_plan_of_the_path_shapes():
    """The shipped rule: RMSNorm and the epilogue without an activation or
    dropout (every junction the paths launch) a block a row in registers,
    at every row count the paths launch; an activation or dropout, and
    rows past 8192, the shared-memory arm."""
    for rows, hidden in ((1, 4096), (8, 4096), (512, 4096), (1024, 4096),
                         (2048, 2048), (2172, 2048), (4096, 4096),
                         (8192, 768)):
        for p in (rn.plan(rows, hidden),
                  be.plan(rows, hidden, None, False)):
            assert (p.arm, p.blocks) == (nr.ROW, rows)
            assert p.threads == max(32, hidden // 8)
        for act, drop in (("gelu", False), ("swiglu", False), (None, True)):
            assert be.plan(rows, hidden, act, drop).arm == nr.WIDE
    assert rn.plan is nr.plan
    p = nr.plan(5, 12288)
    assert (p.arm, p.threads, p.blocks) == (nr.WIDE, 1024, 5)
    with pytest.raises(ValueError):
        rn.rms_norm(torch.zeros(1, nr.WIDE_HIDDEN + 8, device="meta"),
                    torch.zeros(nr.WIDE_HIDDEN + 8, device="meta"))


def test_word_and_constants_match_the_source():
    src = _header()
    assert _const(src, "kMaxThreads") == nr.MAX_THREADS == 1024
    assert _const(src, "kRegHidden") == nr.REG_HIDDEN == 8192
    assert _const(src, "kWideHidden") == nr.WIDE_HIDDEN == 58080
    assert "enum Arm { kRow = 0, kWide = 1 };" in src
    assert (nr.ROW, nr.WIDE) == (0, 1)
    fields = {k: (int(sh or 0), int(m, 16)) for k, sh, m in re.findall(
        r"l\.(\w+) = (?:\(\w+\))?\(*word(?: >> (\d+))?\)? & (0x[0-9a-fA-F]+)",
        src)}
    assert set(fields) == {"threads", "arm", "blocks"}

    def decode(word):
        return {k: (word >> sh) & m for k, (sh, m) in fields.items()}
    for p in (nr.make(nr.ROW, 8, 4096), nr.make(nr.WIDE, 4096, 768),
              nr.make(nr.WIDE, 2 ** 31 - 1, 12288),
              nr.make(nr.ROW, 1061, 8192)):
        assert decode(p.word) == {"threads": p.threads, "arm": p.arm,
                                  "blocks": p.blocks}


def test_c_argument_lists():
    """The ctypes lists match the C entries, the plan a 64-bit word."""
    import ctypes
    for lib, name, args in (("rms_norm", "ptt_rms_norm", rn._ARGS),
                            ("block_epilogue", "ptt_block_epilogue",
                             be._ARGS)):
        src = (CSRC / f"{lib}.cu").read_text()
        sig = re.search(rf"{name}\(([^)]*)\)", src).group(1)
        params = [a.strip() for a in sig.split(",")]
        assert len(params) == len(args), name
        assert params[-2] == "long long plan"
        assert args[-2] is ctypes.c_longlong
        assert "rw::decode(plan)" in src and "rw::valid(l, rows, hidden)" \
            in src


def test_epilogue_dispatch_holds_in_registers_only_light_variants():
    """The epilogue's C dispatch instantiates a block a row in registers
    only where ``kInRegisters`` (no activation, no dropout), the rule
    ``block_epilogue.plan`` follows, and refuses it elsewhere."""
    src = (CSRC / "block_epilogue.cu").read_text()
    assert "constexpr bool kInRegisters = ACT == kNone && !DROP;" in src
    body = src[src.index("int launch(const rw::Launch& l, const FwdArgs& a"):]
    body = body[:body.index("\n}\n")]
    assert "if constexpr (kInRegisters<ACT, DROP>)" in body
    assert "return (int)cudaErrorInvalidValue;" in body


@pytest.mark.parametrize("arm", ARMS, ids=ARM_IDS)
def test_declared_launches_follow_the_plan(monkeypatch, arm):
    """Each example's launch is its plan's (grid, threads, the kernel's arm
    argument, the wide arm's shared row), with no finding of the
    declaration plane at a decode batch, a tail and a larger grid."""
    def forced(rows, hidden, *variant):
        return nr.make(arm, rows, hidden)
    monkeypatch.setattr(rn, "plan", forced)
    monkeypatch.setattr(be, "plan", forced)
    for rows, hidden in ((8, 4096), (37, 776), (300, 2048)):
        p = forced(rows, hidden)
        for ex in (rn._ex_fwd("x", rows, hidden, True),
                   be._ex_fwd("x", rows, hidden, None, "layer", 0.0, True)):
            (k,) = ex.kernels
            assert k.grid == (p.blocks, 1, 1) and k.threads == p.threads
            assert k.kernel.endswith(f",{arm}>")
            assert k.smem == (4 * hidden if arm == nr.WIDE else 0)
            found = [f for f in check_example(ex) if f.rule_id != "CK204"]
            assert found == []


def test_declared_bytes():
    rows, hd = 37, 776
    for res in (False, True):
        ex = rn._ex_fwd("x", rows, hd, res)
        assert ex.nbytes == rn.declared_bytes(rows, hd, res) == \
            2 * rows * hd * (2 + 2 * res) + 2 * hd
    for act, bias in ((None, False), ("swiglu", True), ("gelu", False)):
        ex = be._ex_fwd("x", rows, hd, act, "layer" if bias else "rms", 0.0,
                        bias)
        xw = hd * (2 if act == "swiglu" else 1)
        assert ex.nbytes == be.declared_bytes(rows, hd, act, bias) == \
            2 * (rows * xw + 3 * rows * hd + hd * (1 + bias))


# -- against the JAX package -----------------------------------------------------

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
@pytest.mark.parametrize("residual", [False, True])
def test_rms_norm_against_jax(dtype, residual):
    """37 rows of H 264 (33 vectors: a warp and one idle lane group)
    through ``nn.functional.rms_norm`` / ``fused_rms_norm_add`` against
    ``rms_norm_pallas.rms_norm_fused`` in interpret mode."""
    rng = np.random.default_rng(190 + residual)
    x, res = (rng.standard_normal((37, 264)).astype(np.float32)
              for _ in range(2))
    w = (1.0 + 0.1 * rng.standard_normal(264)).astype(np.float32)
    (jx, tx), (jr, tr), (jw, tw) = (_both(a, dtype) for a in (x, res, w))
    y_j, h_j = jrms.rms_norm_fused(jx, jw, jr if residual else None, 1e-5,
                                   True)
    if residual:
        y_t, h_t = F.fused_rms_norm_add(tx, tr, tw, 1e-5)
        _close(h_t, h_j, TOL[dtype])
    else:
        y_t = F.rms_norm(tx, tw, 1e-5)
    _close(y_t, y_j, TOL[dtype])


EPI_COMBOS = [(act, norm, bias, p) for act in (None, "gelu", "swiglu")
              for norm, bias in (("rms", False), ("layer", False),
                                 ("layer", True))
              for p in (0.0, 0.3)]


@pytest.mark.parametrize("act,norm,bias,p", EPI_COMBOS)
def test_block_epilogue_against_jax(act, norm, bias, p):
    """bf16, 37 rows of H 264 through ``nn.functional.
    fused_dropout_add_norm`` against ``block_fused_pallas.fused_epilogue``
    in interpret mode; with dropout, the dropped positions of both are the
    counter hash's (with a zero residual and x away from 0, h is 0 exactly
    where an element was dropped)."""
    rng = np.random.default_rng(191 + len(str(act)) + 7 * bias + int(10 * p))
    hd, seed = 264, 4321
    xw = 2 * hd if act == "swiglu" else hd
    x = (np.abs(rng.standard_normal((37, xw))) + 0.5).astype(np.float32)
    res = rng.standard_normal((37, hd)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(hd)).astype(np.float32)
    b = (0.1 * rng.standard_normal(hd)).astype(np.float32)
    (jx, tx), (jr, tr), (jw, tw), (jb, tb) = (_both(a, "bfloat16")
                                              for a in (x, res, w, b))
    y_j, h_j = jbf.fused_epilogue(jx, jr, jw, jb if bias else None,
                                  jnp.int32(seed), p, 1e-5, act, norm, None,
                                  True)
    y_t, h_t = F.fused_dropout_add_norm(tx, tr, tw, tb if bias else None, p,
                                        1e-5, norm, act, seed)
    _close(h_t, h_j, TOL["bfloat16"])
    _close(y_t, y_j, TOL["bfloat16"])
    if p:
        zero_j, zero_t = jnp.zeros_like(jr), torch.zeros_like(tr)
        _, h0_j = jbf.fused_epilogue(jx, zero_j, jw, jb if bias else None,
                                     jnp.int32(seed), p, 1e-5, act, norm,
                                     None, True)
        _, h0_t = F.fused_dropout_add_norm(tx, zero_t, tw,
                                           tb if bias else None, p, 1e-5,
                                           norm, act, seed)
        dropped = np.asarray(jnp.asarray(h0_j, jnp.float32)) == 0.0
        np.testing.assert_array_equal(h0_t.float().numpy() == 0.0, dropped)
        keep = be.keep_mask(37, hd, seed, p).numpy()
        np.testing.assert_array_equal(dropped, ~keep)
