"""The Hopper weight-only kernels (rows 12a, 12b and 12c of
``csrc/wo_matmul.cu``: ``wo_prefill_kernel`` and ``wo_decode_kernel`` in
the int8, grouped int8 and packed int4 modes) as far as the CPU can hold
them.

- The launches that ``wo_matmul.ck_examples()`` declares: every element
  of y is written by exactly one block, at every example and tail (the
  decode kernel's K split writes no partial buffer: block r of a cluster
  writes the 16-column chunks r, r + split, .. of its column tile after
  adding the blocks' partial sums through distributed shared memory; a
  packed int4 tile's chunks lie half in y's first half of columns, half
  in its second); each launch stays inside the card's 227 KB of shared
  memory a block and 1024 threads, its cluster inside the portable 8
  blocks; the declared tiles, threads, stages and launch plans are the
  source's own, at both widths of the int4 decode tile.
- The scale rows a 64-row stage can span, for every G, never exceed the
  rows the kernels' TMA box holds.
- The wrapper's kernel-side checks raise on f32, K % 8, N % 16 (int4: N
  % 32) and mixed devices (on fake CUDA tensors: nothing launches).
- The plain version, which the card tests hold the kernels to, against
  ``wo_matmul_pallas.wo_int8_matmul`` in interpret mode at K 264, 1032 and
  4096 with every G of 3, 8, 24, 128 that divides K and per-channel
  scales, at three numpy seeds: bf16 to one bf16 ulp of the largest value
  (one f32 sum rounded once, summed in another order); the grouped
  dequantised weight, rounded to bf16 before the contraction, bit for
  bit; the wrapper on CPU tensors equals the plain version bit for bit, as
  ``tests/test_torch_quant.py`` requires. The int4 plain version against
  ``wo_matmul_pallas.wo_int4_matmul`` in interpret mode at the same K and
  seeds, to one bf16 ulp, and the wrapper bit for bit the plain version.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from paddle_tpu.ops.kernels import wo_matmul_pallas
from paddle_tpu_torch.cost_model import device_preset
from paddle_tpu_torch.ops.kernels import wo_matmul as wo

SOURCE = Path(wo.__file__).resolve().parents[2] / "csrc" / "wo_matmul.cu"
KERNELS = ("wo_prefill_kernel", "wo_decode_kernel")


def _examples():
    return [e for ex in wo.ck_examples() for e in (ex, ex.tail)]


@pytest.mark.parametrize("ex", _examples(), ids=lambda e: e.label)
def test_declared_writes_cover_each_output_element_once(ex):
    (k,) = ex.kernels
    (m,) = k.writes
    assert m.operand == "y"
    c = np.zeros(m.array_shape, np.int32)
    for b in k.block_ids():
        for t in m.eval_index(b):
            c[m.element_slices(t)] += 1
    assert c.min() == 1 and c.max() == 1, (c.min(), c.max())


def test_examples_cover_both_kernels_both_modes():
    names = {e.kernels[0].kernel for e in _examples()}
    assert names >= {"wo_prefill_kernel<0,256>", "wo_prefill_kernel<1,256>",
                     "wo_prefill_kernel<0,128>", "wo_prefill_kernel<1,128>",
                     "wo_prefill_kernel<2,256>", "wo_prefill_kernel<2,128>",
                     "wo_decode_kernel<0,1,128>", "wo_decode_kernel<1,1,128>",
                     "wo_decode_kernel<2,1,128>", "wo_decode_kernel<2,1,256>"}, \
        names
    assert all(n.startswith(KERNELS) for n in names)
    assert len(_examples()) == 30


@pytest.mark.parametrize("m,k,n,cols", [
    (8, 4096, 14336, 256), (16, 4096, 14336, 256), (5, 264, 8480, 256),
    (16, 1032, 8480, 256), (8, 14336, 4096, 128), (8, 4096, 1024, 128),
    (16, 264, 2080, 128), (5, 1032, 1056, 128)])
def test_int4_decode_widths_cover_each_output_element_once(cols, m, k, n):
    """Both widths of the int4 decode tile, each at shapes the plan gives
    it: 128 columns from a 64-byte box of packed bytes a row, 256 from a
    128-byte box; N/2 = 4240, 1040 and 528 end inside a box."""
    from paddle_tpu_torch.ops.kernels._examples import model
    k_ = wo._wo_launch(model(), "wo_int4", m, k, n, 128)
    assert k_.kernel == f"wo_decode_kernel<2,{1 if m <= 8 else 2},{cols}>"
    assert k_.grid == (k_.cluster[0], -(-n // cols), 1)
    (mp,) = k_.writes
    op = model().Operand("y", (m, n), torch.bfloat16, "out")
    mp.bind(op)
    c = np.zeros(mp.array_shape, np.int32)
    for b in k_.block_ids():
        for t in mp.eval_index(b):
            c[mp.element_slices(t)] += 1
    assert c.min() == 1 and c.max() == 1, (c.min(), c.max())


@pytest.mark.parametrize("ex", _examples(), ids=lambda e: e.label)
def test_launches_fit_the_card(ex):
    preset = device_preset()
    (k,) = ex.kernels
    assert k.smem <= preset["smem_per_block_optin"] == 232448, k.kernel
    assert k.threads <= 1024 and k.threads % 32 == 0, k.kernel
    if k.kernel.startswith("wo_decode_kernel"):
        # a cluster is at most the portable 8 blocks, and its K split
        # leaves no block without k rows
        assert 1 <= k.grid[0] <= 8
        assert k.cluster == (k.grid[0], 1, 1)
        # three decode blocks an SM at the path's shapes (phase 3)
        if ex.label.startswith("phase3") and "tail" not in ex.label:
            assert 3 * (k.smem + 1024) <= wo._SMEM_SM, k.smem


def _constants():
    src = SOURCE.read_text()
    return {m.group(1): int(m.group(2)) for m in
            re.finditer(r"constexpr int (k\w+) = (\d+);", src)}, src


def test_declarations_match_the_source():
    c, src = _constants()
    assert (c["kSmemMax"], c["kBK"], c["kBN"]) == (wo._SMEM_MAX, wo._BK,
                                                  wo._BN)
    assert (c["kPreThreads"], c["kPreStages"], c["kPreConv"]) == \
        (wo._PRE_THREADS, wo._PRE_STAGES, wo._PRE_CONV)
    assert (c["kDecThreads"], c["kDecStages"], c["kDecSplit"], c["kXRow"],
            c["kSms"], c["kSmemSm"]) == (
        wo._DEC_THREADS, wo._DEC_STAGES, wo._DEC_SPLIT, wo._XROW, wo._SMS,
        wo._SMEM_SM)
    assert wo._XROW == wo._BK + 8
    # two consumer warpgroups then a producer warp; four consumer warps
    # then a producer warp
    assert wo._PRE_THREADS == 2 * 128 + 32
    assert wo._DEC_THREADS == 4 * 32 + 32
    assert (c["kDecBlocks8"], c["kDecBlocks16"]) == (wo._dec_blocks(1),
                                                    wo._dec_blocks(2))
    for name in KERNELS:
        assert f"    {name}(" in src
    assert "wo_matmul_kernel" not in src and "launch_int4" not in src
    assert "launch_prefill<MODE, 256>" in src and \
        "launch_prefill<MODE, 128>" in src
    assert "launch_decode<MODE, 2, kBN>" in src and \
        "launch_decode<MODE, 1, kBN>" in src
    assert "launch_decode<MODE, 2, 256>" in src and \
        "launch_decode<MODE, 1, 256>" in src
    assert "inline int int4_dec_cols(int M, int N)" in src
    assert "return (long long)tiles * kDecSplit > (long long)dec_blocks(" \
        "M > 8 ? 2 : 1, 2 * kBN) * kSms" in src
    assert "int4_dec_cols(M, N)," in src and "ptt_wo_int4_cols" not in src
    assert wo._w_tile(0) == wo._w_tile(1) == 8192 and wo._w_tile(2) == 4096
    assert wo._w_tile(2, 256) == 8192


def test_plans_at_the_path_shapes():
    """The launch plans at Llama-3-8B's projections: prefill gate/up,
    q/o_proj and down in 256-row tiles with four ring stages (x 32 KB +
    weight 8 KB a stage, three converted 16 KB tiles), k_proj at 1024 and
    1531 rows in 128-row tiles with six (32 or 48 tall tiles would leave
    most of the card idle); decode at 8 tokens split to fill 3 blocks an
    SM once (gate/up in 3: 336 blocks), with eight stages of 8 KB of
    weight and 1152 B of x (seven with the grouped scale row); 16 tokens 2
    blocks an SM."""
    bars = 16 * 6
    assert wo._prefill_plan(False, 1024, 14336, 0) == \
        (256, 4, 1024 + 3 * 16384 + bars + 4 * (32768 + 8192))
    assert wo._prefill_plan(True, 1024, 14336, 1) == \
        (256, 4, 1024 + 3 * 16384 + bars + 4 * (32768 + 8192 + 1024))
    assert wo._prefill_plan(False, 1024, 4096, 0)[:2] == (256, 4)
    assert wo._prefill_plan(False, 1024, 1024, 0)[:2] == (128, 6)
    assert wo._prefill_plan(False, 1531, 1024, 0)[:2] == (128, 6)
    assert wo._prefill_plan(True, 1531, 4096, wo._scale_rows(1))[:2] \
        == (128, 3)
    x_stage = 8 * 72 * 2
    assert wo._decode_plan(False, 8, 14336, 4096, 0) == \
        (1, 3, 1408, 8, 1024 + 128 + 8 * (8192 + x_stage))
    assert wo._decode_plan(True, 8, 14336, 4096, 1)[:4] == (1, 3, 1408, 7)
    assert wo._decode_plan(True, 8, 4096, 14336, 1)[:4] == (1, 8, 1792, 7)
    assert wo._decode_plan(False, 16, 1024, 4096, 0)[:4] == (2, 8, 512, 8)
    assert wo._decode_plan(True, 5, 1056, 1032, wo._scale_rows(8))[:4] \
        == (1, 6, 192, 5)
    for tg, m in ((1, 8), (2, 16)):
        for grouped, srows in ((False, 0), (True, 1)):
            smem = wo._decode_plan(grouped, m, 14336, 4096, srows)[4]
            assert wo._dec_blocks(tg) * (smem + 1024) <= wo._SMEM_SM
        for nc in (128, 256):
            smem = wo._decode_plan(2, m, 14336, 4096, 0, nc)[4]
            assert wo._dec_blocks(tg, nc) * (smem + 1024) <= wo._SMEM_SM


def test_int4_plans_at_the_path_shapes():
    """Packed int4 (mode 2) at Llama-3-8B's projections: prefill takes the
    int8 tilings with a 4 KB weight stage ([64 k, 64 bytes]); decode at
    128 columns a block splits and stages as int8 does with half the
    weight bytes a stage, at 256 columns it holds two blocks an SM and
    splits K twice as far."""
    bars = 16 * 6
    assert wo._prefill_plan(2, 1024, 14336, 0) == \
        (256, 4, 1024 + 3 * 16384 + bars + 4 * (32768 + 4096))
    assert wo._prefill_plan(2, 1024, 4096, 0)[:2] == (256, 4)
    assert wo._prefill_plan(2, 1531, 1024, 0) == \
        (128, 6, 1024 + 3 * 16384 + bars + 6 * (16384 + 4096))
    x_stage = 8 * 72 * 2
    assert wo._decode_plan(2, 8, 14336, 4096, 0) == \
        (1, 3, 1408, 8, 1024 + 128 + 32768 + 8 * x_stage)
    assert wo._decode_plan(2, 8, 4096, 14336, 0)[:4] == (1, 8, 1792, 8)
    assert wo._decode_plan(2, 8, 14336, 4096, 0, 256) == \
        (1, 4, 1024, 8, 1024 + 128 + 65536 + 8 * x_stage)
    assert wo._decode_plan(2, 8, 4096, 14336, 0, 256)[:4] == (1, 8, 1792, 8)
    assert wo._decode_plan(2, 16, 1024, 4096, 0, 256)[:2] == (2, 8)
    assert wo._dec_blocks(1, 256) == wo._dec_blocks(2) == 2


@pytest.mark.parametrize("m,k,n,cols", [
    (8, 4096, 14336, 256), (16, 4096, 14336, 256), (8, 14336, 4096, 128),
    (8, 4096, 4096, 128), (8, 4096, 1024, 128), (5, 1032, 1056, 128)])
def test_int4_decode_width_at_the_path_shapes(m, k, n, cols):
    """The int4 decode tile is 256 columns wide where that grid's K split
    is set by the card's slots and not capped at 8 blocks: gate/up (56
    tiles at two blocks an SM: split 4, 224 of 264 slots); 128 at down,
    q/o and k/v, whose 16 or 4 tiles of 256 columns would take the capped
    split 8 and leave at least half the slots empty, and at the small
    tail."""
    assert wo._int4_dec_cols(m, n) == cols


@pytest.mark.parametrize("k", [64, 264, 1000, 1032, 4096])
def test_scale_rows_hold_every_stage(k):
    """Scale rows of [K/G, N] that stage k0 .. k0 + 63 needs, for every G
    dividing K, against the rows the TMA box carries (at most 64; 1 where
    G is a multiple of 64)."""
    for g in range(1, k + 1):
        if k % g:
            continue
        need = max((min(k0 + 63, k - 1)) // g - k0 // g + 1
                   for k0 in range(0, k, 64))
        assert need <= wo._scale_rows(g) <= 64, (g, need)
        if g % 64 == 0:
            assert wo._scale_rows(g) == 1


@pytest.mark.parametrize("what", ["f32", "K % 8", "N % 16", "devices",
                                  "int4 N % 32"])
def test_kernel_checks_raise(what):
    with FakeTensorMode():
        x = torch.empty(4, 256, dtype=torch.bfloat16, device="cuda")
        w = torch.empty(256, 64, dtype=torch.int8, device="cuda")
        s = torch.empty(64, device="cuda")
        if what == "f32":
            x = x.float()
        elif what == "K % 8":
            x = torch.empty(4, 252, dtype=torch.bfloat16, device="cuda")
            w = torch.empty(252, 64, dtype=torch.int8, device="cuda")
        elif what == "N % 16":
            w = torch.empty(256, 72, dtype=torch.int8, device="cuda")
            s = torch.empty(72, device="cuda")
        elif what == "int4 N % 32":
            w = torch.empty(256, 24, dtype=torch.int8, device="cuda")
            s = torch.empty(48, device="cuda")
            assert wo.unsupported_reason(x, w, s, int4=True) is not None
            with pytest.raises(ValueError, match="weight-only kernel does"):
                wo._operands(x, w, s, int4=True)
            return
        else:
            s = torch.empty(64)
        assert wo.unsupported_reason(x, w, s) is not None
        with pytest.raises(ValueError, match="weight-only kernel does not"):
            wo._operands(x, w, s)
        # grouped scales take the same checks
        with pytest.raises(ValueError):
            wo._operands(x, w, s.reshape(1, -1))


def _cases():
    out = []
    for k in (264, 1032, 4096):
        for g in (None, 3, 8, 24, 128):
            if g is None or k % g == 0:
                out.append((k, g))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k,g", _cases())
def test_plain_equals_jax_kernel(seed, k, g):
    m, n = 5, 256
    rng = np.random.default_rng(100 * seed + k + (g or 0))
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    s_shape = (n,) if g is None else (k // g, n)
    s = (rng.random(s_shape) * 2e-3 + 1e-4).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tw, ts = torch.from_numpy(w), torch.from_numpy(s)
    want = np.asarray(wo_matmul_pallas.wo_int8_matmul(
        jx, jnp.asarray(w), jnp.asarray(s), interpret=True).astype(jnp.float32))
    got = wo.wo_int8_matmul_plain(tx, tw, ts)
    assert torch.equal(wo.wo_int8_matmul(tx, tw, ts), got)
    assert np.abs(got.float().numpy() - want).max() <= \
        2.0 ** -7 * np.abs(want).max()
    if g is not None:
        jd = wo_matmul_pallas.dequant_grouped(jnp.asarray(w), jnp.asarray(s))
        np.testing.assert_array_equal(
            wo.dequant_grouped(tw, ts).to(torch.bfloat16).float().numpy(),
            np.asarray(jd.astype(jnp.bfloat16).astype(jnp.float32)))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [264, 1032, 4096])
def test_int4_plain_equals_jax_kernel(seed, k):
    m, n = 5, 256
    rng = np.random.default_rng(100 * seed + k + 7)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.integers(-128, 128, (k, n // 2)).astype(np.int8)
    s = (rng.random(n) * 2e-3 + 1e-4).astype(np.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tw, ts = torch.from_numpy(w), torch.from_numpy(s)
    want = np.asarray(wo_matmul_pallas.wo_int4_matmul(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(s),
        interpret=True).astype(jnp.float32))
    got = wo.wo_int4_matmul_plain(tx, tw, ts)
    assert torch.equal(wo.wo_int4_matmul(tx, tw, ts), got)
    assert np.abs(got.float().numpy() - want).max() <= \
        2.0 ** -7 * np.abs(want).max()
    np.testing.assert_array_equal(
        wo.unpack_int4_halves(tw).numpy(),
        np.asarray(wo_matmul_pallas.unpack_int4_halves(jnp.asarray(w))))
