"""The Hopper A8W8 product (row 13, ``csrc/a8w8_matmul.cu``) and the
block-epilogue backward (row 10, ``csrc/block_epilogue.cu``) as far as the
CPU can hold them.

- The launches that ``a8w8_matmul.ck_examples()`` and the backward's
  examples of ``block_epilogue.ck_examples()`` declare: every element of
  each output (y, q, s, the "kn" weight's K-major copy; dx, dres, the
  summed dw and db) is written by exactly one block, and every partial row
  by exactly one block of the rows kernel, at every example and tail;
  each launch stays inside the card's 227 KB of shared memory a block and
  its thread limits.
- The Python plans are the source's own: the constants read from the
  sources, the row strips (each row walked by exactly one group, the grid
  one wave of the card), and the plans at the path's shapes.
- The old kernels are gone, and the wrapper's partial sums are a kernel,
  not two library reductions.
- The wrappers' kernel-side checks raise (on fake CUDA tensors: nothing
  launches).

The plain versions are held against the JAX package in
``tests/test_torch_quant.py`` and ``tests/test_torch_epilogue_bwd.py``;
the kernels against the plain versions on the card in
``tests/test_torch_cuda.py``.
"""

import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from paddle_tpu_torch.cost_model import device_preset
from paddle_tpu_torch.ops.kernels import a8w8_matmul as a8
from paddle_tpu_torch.ops.kernels import block_epilogue as be

CSRC = Path(a8.__file__).resolve().parents[2] / "csrc"


def _a8w8_examples():
    return [e for ex in a8.ck_examples() for e in (ex, ex.tail)]


def _bwd_examples():
    return [e for ex in be.ck_examples() for e in (ex, ex.tail)
            if e.kernels[0].kernel.startswith("block_epilogue_bwd")]


def _coverage(kernel, tile_map):
    """Writes of each element (of each tile, for an operand past 2**24
    elements: the tiles then cover it exactly when each is written once)."""
    big = int(np.prod(tile_map.array_shape)) > 2 ** 24
    c = np.zeros(tile_map.nblocks if big else tile_map.array_shape, np.int32)
    for b in kernel.block_ids():
        for t in tile_map.eval_index(b):
            if big:
                c[t] += 1
            else:
                c[tile_map.element_slices(t)] += 1
    return c


def _constants(name):
    src = (CSRC / name).read_text()
    return {m.group(1): int(m.group(2)) for m in
            re.finditer(r"constexpr int (k\w+) = (\d+);", src)}, src


@pytest.mark.parametrize("ex", _a8w8_examples() + _bwd_examples(),
                         ids=lambda e: e.label)
def test_declared_writes_cover_each_element_once(ex):
    """Every declared output of every launch: each element, and each
    partial row, written by exactly one block."""
    seen = set()
    for k in ex.kernels:
        for m in k.writes:
            c = _coverage(k, m)
            assert c.min() == 1 and c.max() == 1, (k.kernel, m.operand,
                                                   c.min(), c.max())
            seen.add(m.operand)
    assert seen == {op.name for op in ex.outputs}, seen


@pytest.mark.parametrize("ex", _a8w8_examples() + _bwd_examples(),
                         ids=lambda e: e.label)
def test_launches_fit_the_card(ex):
    preset = device_preset()
    for k in ex.kernels:
        assert k.smem <= preset["smem_per_block_optin"] == 232448, k.kernel
        assert k.threads <= 1024 and k.threads % 32 == 0, k.kernel
        assert k.grid[1] <= 65535 and k.grid[2] <= 65535, k.kernel


def test_a8w8_examples_cover_every_kernel_and_layout():
    names = [[k.kernel for k in e.kernels] for e in _a8w8_examples()]
    assert ["a8w8_quantize_kernel", "a8w8_wgmma_kernel"] in names
    assert ["a8w8_quantize_kernel", "a8w8_transpose_kernel",
            "a8w8_wgmma_kernel"] in names
    assert len(names) == 8


def test_a8w8_constants_match_the_source():
    c, src = _constants("a8w8_matmul.cu")
    assert (c["kQuantThreads"], c["kQuantVecs"]) == (a8._QUANT_THREADS,
                                                     a8._QUANT_VECS)
    assert (c["kBM"], c["kBN"], c["kBK"], c["kThreads"], c["kStages"],
            c["kTile"]) == (a8._BM, a8._BN, a8._BK, a8._THREADS,
                            a8._STAGES, a8._TILE)
    # two consumer warpgroups of 64 rows, then a producer warp; the ring
    # and its mbarriers after a 1 KB alignment pad
    assert a8._THREADS == 2 * 128 + 32 and a8._BM == 2 * 64
    assert a8._SMEM == 1024 + 4 * (128 + 256) * 128 + 64 == 197696
    assert "constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * " \
        "kStages * 8;" in src
    # the row is read once into registers through K = 8192
    assert a8._QUANT_THREADS * a8._QUANT_VECS * 8 == 8192
    assert "a8w8_gemm_kernel" not in src and "mma_s8" not in src
    assert "hp::WgmmaS8<kBN>::ss(" in src
    assert "WgmmaS8<256>" in (CSRC / "hopper.cuh").read_text()


def test_a8w8_plan_at_the_path_shape():
    """llm_int8's prefill [1024, 4096] @ nk [14336, 4096]: 448 blocks of
    128 x 256 (3.39 waves on 132 SMs), 32 k-steps of 128 bytes, a block
    of 128 threads a row for the quantisation."""
    ex = next(e for e in a8.ck_examples()
              if e.label == "phase3 [1024, 4096] @ nk [14336, 4096]")
    quant, prod = ex.kernels
    assert quant.grid == (1024, 1, 1) and quant.block == (128, 1, 1)
    assert prod.grid == (8, 56, 1) and prod.blocks == 448
    assert prod.smem == 197696 and prod.block == (288, 1, 1)
    assert 4096 // a8._BK == 32


def test_bwd_constants_match_the_source():
    c, src = _constants("block_epilogue.cu")
    assert (c["kSms"], c["kSmemSm"], c["kMaxThreads"], c["kBlockWarps"]) \
        == (be._SMS, be._SMEM_SM, be._MAX_THREADS, be._BLOCK_WARPS)
    assert (c["kNarrowVecs"], c["kWideVecs"], c["kMaxGroupWarps"],
            c["kStages"], c["kSumRows"]) == (
        be._NARROW_VECS, be._WIDE_VECS, be._MAX_GROUP_WARPS, be._STAGES,
        be._SUM_ROWS)
    assert be._MAX_THREADS == 32 * be._MAX_GROUP_WARPS
    for name in ("block_epilogue_bwd_rows_kernel(",
                 "block_epilogue_bwd_sum_kernel("):
        assert name in src
    assert "block_epilogue_bwd_kernel(" not in src and "block_sums" not in src
    assert "inline BwdPlan bwd_plan(int rows, int hidden, bool bias, " \
        "bool has_gh)" in src
    # the C entry refuses a partial buffer of another plan
    assert "n_part != p.blocks" in src


def test_bwd_wrapper_sums_by_kernel():
    """The partial rows are added by the sum kernel inside the C entry:
    the wrapper calls no library reduction on them."""
    src = inspect.getsource(be.fused_epilogue_bwd)
    assert ".sum(" not in src and "_launch_bwd(" in src


def _strips(rows, plan):
    """How many groups walk each row."""
    seen = np.zeros(rows, np.int32)
    for b in range(plan.blocks):
        for grp in range(plan.groups):
            r0 = (b * plan.groups + grp) * plan.rows_per_group
            seen[r0:min(rows, r0 + plan.rows_per_group)] += 1
    return seen


@pytest.mark.parametrize("rows", [1, 37, 1061, 4096, 8192])
@pytest.mark.parametrize("hidden", [64, 768, 776, 1024, 4096, 8192, 8200,
                                    12288, 19280])
@pytest.mark.parametrize("bias,gh", [(False, True), (True, True),
                                     (False, False)])
def test_bwd_plan_walks_each_row_once_in_one_wave(rows, hidden, bias, gh):
    if bias and (3 + 1) * hidden * 4 > be._BWD_SMEM:
        return                       # the wrapper refuses it (test below)
    p = be._bwd_plan(rows, hidden, bias, gh)
    seen = _strips(rows, p)
    assert seen.min() == 1 and seen.max() == 1
    vecs = hidden // 8
    assert p.group_warps * 32 * p.vecs >= vecs > (p.group_warps - 1) * 32 \
        * p.vecs
    assert p.group_warps <= be._MAX_GROUP_WARPS
    assert p.threads == p.groups * p.group_warps * 32 <= be._MAX_THREADS
    # the blocks an SM the plan assumes fit its shared memory and 128
    # registers a thread, and the grid is one wave of them
    assert p.blocks_sm * (p.smem + 1024) <= be._SMEM_SM
    assert p.blocks_sm * p.threads * 128 <= 65536
    assert p.blocks <= be._SMS * p.blocks_sm
    assert p.smem <= be._BWD_SMEM
    if p.vecs == be._NARROW_VECS and p.groups > 1:
        # the groups' dw (and db) combine over the stages at the end
        assert (1 + bias) * hidden * 4 <= p.smem


def test_bwd_plans_at_the_path_shapes():
    """GPT-2 small's [8192, 768] (layer norm, a bias): 2-warp groups, 4 a
    block, 8 rows a group, 256 partial rows (1.6 MB of dw and db);
    Llama's [4096, 4096]: 8-warp groups, 16 rows each, 256
    partial rows; both two blocks an SM with three staged rows a group."""
    p = be._bwd_plan(8192, 768, True, True)
    assert (p.vecs, p.group_warps, p.groups, p.threads) == (2, 2, 4, 256)
    assert (p.rows_per_group, p.blocks, p.blocks_sm) == (8, 256, 2)
    assert p.smem == 4 * 3 * (3 * 768 * 2 + 8)
    assert 2 * p.blocks * 768 * 4 == 1572864
    p = be._bwd_plan(4096, 4096, False, True)
    assert (p.vecs, p.group_warps, p.groups, p.threads) == (2, 8, 1, 256)
    assert (p.rows_per_group, p.blocks, p.blocks_sm) == (16, 256, 2)
    p = be._bwd_plan(5, 12288, True, True)
    assert (p.vecs, p.group_warps, p.groups) == (8, 6, 1)
    assert p.smem == 2 * 12288 * 4


def test_bwd_examples_cover_both_widths():
    names = {e.kernels[0].kernel for e in _bwd_examples()}
    assert any(n.endswith(",2>") for n in names)
    assert any(n.endswith(",8>") for n in names)
    assert all(e.kernels[1].kernel == "block_epilogue_bwd_sum_kernel"
               for e in _bwd_examples())


@pytest.mark.parametrize("what", ["f32", "K % 16", "kn N % 16", "int32 w"])
def test_a8w8_kernel_checks_raise(what):
    with FakeTensorMode():
        x = torch.empty(4, 256, dtype=torch.bfloat16, device="cuda")
        w = torch.empty(64, 256, dtype=torch.int8, device="cuda")
        ws = torch.empty(64, device="cuda")
        layout = "nk"
        err = ValueError
        if what == "f32":
            x = x.float()
        elif what == "K % 16":
            x = torch.empty(4, 248, dtype=torch.bfloat16, device="cuda")
            w = torch.empty(64, 248, dtype=torch.int8, device="cuda")
        elif what == "kn N % 16":
            w = torch.empty(256, 40, dtype=torch.int8, device="cuda")
            ws = torch.empty(40, device="cuda")
            layout = "kn"
        else:
            w = w.int()
        if what != "int32 w":
            assert a8.unsupported_reason(x, w, layout) is not None
        with pytest.raises(err):
            a8.a8w8_matmul(x, w, ws, layout)


@pytest.mark.parametrize("what", ["f32", "hidden % 8", "too wide",
                                  "strided", "x dtype"])
def test_bwd_kernel_checks_raise(what):
    with FakeTensorMode():
        bf = torch.bfloat16
        h = torch.empty(4, 64, dtype=bf, device="cuda")
        w = torch.empty(64, dtype=bf, device="cuda")
        kw = {}
        err = ValueError
        if what == "f32":
            h, w, err = h.float(), w.float(), TypeError
        elif what == "hidden % 8":
            h, w = (torch.empty(4, 60, dtype=bf, device="cuda"),
                    torch.empty(60, dtype=bf, device="cuda"))
        elif what == "too wide":
            # (3 + bias) * hidden f32 past the contract: 14472 with a bias
            h, w = (torch.empty(2, 14472, dtype=bf, device="cuda"),
                    torch.empty(14472, dtype=bf, device="cuda"))
            kw = dict(norm="layer", has_bias=True)
        elif what == "strided":
            h = torch.empty(64, 4, dtype=bf, device="cuda").t()
        else:
            kw, err = dict(x_dtype=torch.float32), TypeError
        with pytest.raises(err):
            be.fused_epilogue_bwd(h, None, w, h, **kw)
