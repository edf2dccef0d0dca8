"""The Hopper int8 weight-only kernels (rows 12a, 12b of ``csrc/wo_matmul.cu``:
``wo_prefill_kernel`` and ``wo_decode_kernel``) as far as the CPU can hold
them.

- The launches that ``wo_matmul.ck_examples()`` declares for the int8
  kernels: every element of y is written by exactly one block, at every
  example and tail (the decode kernel's K split writes no partial buffer:
  block r of a cluster writes the 16-column chunks r, r + split, .. of its
  column tile after adding the blocks' partial sums through distributed
  shared memory); each launch stays inside the card's 227 KB of shared
  memory a block and 1024 threads; the declared tiles, threads, stages and
  launch plans are the source's own.
- The scale rows a 64-row stage can span, for every G, never exceed the
  rows the kernels' TMA box holds.
- The wrapper's kernel-side checks raise on f32, K % 8, N % 16 and mixed
  devices (on fake CUDA tensors: nothing launches).
- The plain version, which the card tests hold the kernels to, against
  ``wo_matmul_pallas.wo_int8_matmul`` in interpret mode at K 264, 1032 and
  4096 with every G of 3, 8, 24, 128 that divides K and per-channel
  scales, at three numpy seeds: bf16 to one bf16 ulp of the largest value
  (one f32 sum rounded once, summed in another order); the grouped
  dequantised weight, rounded to bf16 before the contraction, bit for
  bit; the wrapper on CPU tensors equals the plain version bit for bit, as
  ``tests/test_torch_quant.py`` requires.
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
INT8_KERNELS = ("wo_prefill_kernel", "wo_decode_kernel")


def _examples():
    out = []
    for ex in wo.ck_examples():
        for e in (ex, ex.tail):
            if e.kernels[0].kernel.startswith(INT8_KERNELS):
                out.append(e)
    return out


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
                     "wo_decode_kernel<0,1>", "wo_decode_kernel<1,1>"}, names
    assert len(_examples()) == 20


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
    for name in INT8_KERNELS:
        assert f"    {name}(" in src
    assert "launch_prefill<MODE, 256>" in src and \
        "launch_prefill<MODE, 128>" in src
    assert "launch_decode<MODE, 2>" in src and "launch_decode<MODE, 1>" in src


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


@pytest.mark.parametrize("what", ["f32", "K % 8", "N % 16", "devices"])
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
