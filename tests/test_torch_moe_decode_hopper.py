"""The Hopper grouped expert product (row 17, ``csrc/moe_gemm.cu``) and the
decode layer (row 11, ``csrc/decode_layer.cu``) as far as the CPU can hold
them.

- The launches that ``moe_gemm.ck_examples()`` and
  ``decode_layer.ck_examples()`` declare: every element of the grouped
  product's output, the zeros past the counts included, is written by
  exactly one block; every launch stays inside the card's 227 KB of shared
  memory a block and its thread limits.
- The Python plans are the sources' own: the constants read from the
  sources, the shared-memory mirrors, the work cut of the decode layer's
  phases (every stage and attention sub-chunk owned by one block, the
  pieces of a tile counted as the kernel counts them, the partial slots
  distinct) and the wgmma accumulator's batch and term columns.
- The f32 activations' split into bf16 terms: three terms hold an f32
  value exactly, two within 2**-16 of it.
- The old kernels are gone; the wrappers' kernel-side checks raise (on fake
  CUDA tensors: nothing launches).

The plain versions are held against the JAX package in
``tests/test_torch_moe_gemm.py`` and ``tests/test_torch_decode_layer.py``;
the kernels against the plain versions on the card in
``tests/test_torch_cuda.py``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from paddle_tpu_torch.cost_model import device_preset
from paddle_tpu_torch.ops.kernels import decode_layer as dl
from paddle_tpu_torch.ops.kernels import moe_gemm as mg

CSRC = Path(mg.__file__).resolve().parents[2] / "csrc"


def _moe_examples():
    return [e for ex in mg.ck_examples() for e in (ex, ex.tail)]


def _dl_examples():
    return [e for ex in dl.ck_examples() for e in (ex, ex.tail)]


def _constants(name):
    src = (CSRC / name).read_text()
    return {m.group(1): int(m.group(2)) for m in
            re.finditer(r"constexpr int (k\w+) = (\d+);", src)}, src


def _coverage(kernel, tile_map):
    """Writes of each tile (each element of a tile is written once when its
    tile is, the kernel masking the edges)."""
    c = np.zeros(tile_map.nblocks, np.int32)
    for b in kernel.block_ids():
        idx = tile_map.eval_index(b)
        for t in idx:
            c[t] += 1
    return c


@pytest.mark.parametrize("ex", _moe_examples(), ids=lambda e: e.label)
def test_grouped_product_writes_each_element_once(ex):
    """Every output tile of every example, live rows, rows past the count
    and groups wholly past it alike, by exactly one block."""
    (k,) = ex.kernels
    (m,) = k.writes
    c = _coverage(k, m)
    assert c.min() == 1 and c.max() == 1, (c.min(), c.max())
    assert m.operand == "out"


@pytest.mark.parametrize("ex", _moe_examples() + _dl_examples(),
                         ids=lambda e: e.label)
def test_launches_fit_the_card(ex):
    preset = device_preset()
    for k in ex.kernels:
        assert k.smem <= preset["smem_per_block_optin"] == 232448, k.kernel
        assert k.threads <= 1024 and k.threads % 32 == 0, k.kernel
        assert k.grid[1] <= 65535 and k.grid[2] <= 65535, k.kernel


def test_examples_cover_both_layouts_capacities_and_widths():
    moe = {(e.kernels[0].kernel, e.operands[0].shape[1])
           for e in _moe_examples()}
    assert {("moe_wgmma_kernel<false>", 274), ("moe_wgmma_kernel<true>", 274),
            ("moe_wgmma_kernel<false>", 547), ("moe_wgmma_kernel<true>", 547),
            ("moe_wgmma_kernel<true>", 37)} <= moe
    names = {e.kernels[0].kernel for e in _dl_examples()}
    # every instantiation the source compiles has an example
    assert names == {"decode_layer_wgmma_kernel<64,8>",
                     "decode_layer_wgmma_kernel<64,16>",
                     "decode_layer_wgmma_kernel<128,8>",
                     "decode_layer_wgmma_kernel<128,16>"}
    assert len(dl.ck_examples()) == 5


def test_moe_constants_match_the_source():
    c, src = _constants("moe_gemm.cu")
    assert (c["kBM"], c["kBN"], c["kBK"], c["kStages"], c["kThreads"]) == (
        mg._BM, mg._BN, mg._BK, mg._STAGES, mg._THREADS)
    # two consumer warpgroups of 64 rows, then a producer warp; two 64-row x
    # boxes and the 128-column weight box a stage, after a 1 KB pad
    assert mg._THREADS == 2 * 128 + 32 and mg._BM == 2 * 64
    assert mg._SMEM == 1024 + 3 * (2 * 64 * 64 * 2 + 128 * 64 * 2) + 48 \
        == 99376
    assert "constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * " \
        "kStages * 8;" in src
    # two blocks an SM fit the SM's 228 KB (with 1 KB reserved a block)
    assert 2 * (mg._SMEM + 1024) <= 233472
    assert "moe_gemm_kernel" not in src and "mma_bf16" not in src
    assert "hp::Wgmma<kBN>::template ss<1>" in src        # MN-major weight
    assert "hp::Wgmma<kBN>::template ss<0>" in src        # K-major weight
    assert "tma_load_3d" in src and "make_3d_map" in src


def test_moe_plan_at_the_path_shapes():
    """Grid (N / 128, C / 128, E): gate/up at capacity 274 is 11 x 3 x 60
    blocks, dx 16 x 3 x 60, train_moe's 547 five row groups."""
    assert mg.plan(274, 1408, 60)[0] == (11, 3, 60)
    assert mg.plan(274, 2048, 60)[0] == (16, 3, 60)
    assert mg.plan(547, 1408, 60)[0] == (11, 5, 60)
    assert mg.plan(1, 8, 2)[0] == (1, 1, 2)


def test_decode_layer_constants_match_the_source():
    c, src = _constants("decode_layer.cu")
    assert (c["kThreads"], c["kCons"], c["kBK"], c["kBoxRows"], c["kTerms"],
            c["kMaxRep"], c["kMaxBatch"], c["kBarriers"]) == (
        dl._THREADS, dl._CONS, dl._BK, dl._BOX_ROWS, dl._TERMS, dl._MAX_REP,
        dl.MAX_BATCH, dl._BARRIERS)
    stages = re.search(r"kStagesOf = NB == 8 \? (\d+) : (\d+);", src)
    assert (int(stages.group(1)), int(stages.group(2))) == (dl._stages(8),
                                                            dl._stages(16))
    assert (c["kSub"], c["kIssue"]) == (dl._SUB, dl._ISSUE)
    assert dl._THREADS == 2 * 128 + 32 == dl._CONS + 32
    assert re.search(r"\bdecode_layer_kernel\b", src) is None
    assert "grid.sync" not in src and "stream_units" not in src
    assert "cudaLaunchCooperativeKernel" in src
    assert "hp::Wgmma<N>::template ss<0>" in src
    for n in (24, 48):
        assert f"struct Wgmma<{n}>" in (CSRC / "hopper.cuh").read_text()
    # the scratch regions, in the mirror's order
    takes = re.findall(r"s\.(\w+) = take\(", src)
    assert takes == ["att", "o_terms", "h1", "a_terms", "ss1", "part",
                     "z_terms", "h2", "ss2"]
    # the counters: in a buffer the caller keeps, cleared by the last block
    assert "return kBarriers + 1 + batch * h_kv + 2 * t2 + t3;" in src
    assert dl.ctrl_words(8, 8, 4096, 14336) == 4 + 1 + 64 + 2 * 32 + 224
    assert "cudaMemsetAsync" not in src


@pytest.mark.parametrize("d,nb,want", [(128, 8, 216520), (128, 16, 227768),
                                       (64, 8, 216520), (64, 16, 227768)])
def test_decode_layer_shared_memory(d, nb, want):
    """The ring (11 or 10 stages of two [64, 64] weight boxes and the [3,
    NB, 64] term box) fills one block an SM; the attention's double buffer
    of keys, values and queries, its scaled queries, probabilities and
    softmax state fit its last stages, leaving the producer at least six
    to fill during attention."""
    assert dl._smem(d, nb) == want <= 232448
    stage = 2 * 64 * 64 * 2 + 3 * nb * 64 * 2
    assert stage % 1024 == 0
    attn = 2 * (2 * 64 + 8) * (d + 8) * 2 + 8 * d * 4 + 8 * 64 * 4 + 96
    early = dl._stages(nb) - -(-attn // stage)
    assert early >= 6
    # weights in flight an SM once attention is done: 160-176 KB
    assert dl._stages(nb) * 2 * 64 * 64 * 2 >= 160 * 1024


def _range_start(w, n, g):
    return n * w // g


def _owner(x, n, g):
    return ((x + 1) * g + n - 1) // n - 1


def _has_range(w, n, g):
    return _range_start(w, n, g) < _range_start(w + 1, n, g)


@pytest.mark.parametrize("tiles,kb,g", [
    (32, 64, 132), (224, 64, 132), (32, 224, 132),    # o_proj, gate/up, down
    (5, 9, 132), (9, 17, 132), (4, 8, 132),           # tails: W < G
    (3, 1, 7), (1, 1, 132)])
def test_phase_cut_owns_every_stage_once(tiles, kb, g):
    """The source's range_start / owner / has_range: the W stages are cut
    into G contiguous ranges; every stage has one owner whose range holds
    it; a tile's pieces are the owners between its first and last stage
    that hold a stage (count_parts); the partial slots block + tile never
    collide and stay below G + tiles."""
    n = tiles * kb
    seen = np.zeros(n, np.int32)
    for w in range(g):
        seen[_range_start(w, n, g):_range_start(w + 1, n, g)] += 1
    assert seen.min() == 1 and seen.max() == 1
    slots = set()
    for x in range(n):
        w = _owner(x, n, g)
        assert _range_start(w, n, g) <= x < _range_start(w + 1, n, g)
    for t in range(tiles):
        lo, hi = _owner(t * kb, n, g), _owner(t * kb + kb - 1, n, g)
        parts = [w for w in range(lo, hi + 1) if _has_range(w, n, g)]
        touching = {_owner(x, n, g) for x in range(t * kb, t * kb + kb)}
        assert set(parts) == touching
        for w in parts:
            assert w + t not in slots and w + t < g + tiles
            slots.add(w + t)


def _att_units(lengths, h_kv, sub=64):
    """Sub-chunks of the flattened (kv head, row, sub-chunk) list."""
    return h_kv * sum(max(1, -(-max(n, 1) // sub)) for n in lengths)


def test_attention_units_at_the_path_shapes():
    """(row, kv head, 64-position) sub-chunks: B 8 over Hkv 8 at positions
    0..1500, B 1 at 900, rep 1 over Hkv 32, and B 16 (PERF.md's plan)."""
    full = [0, 18, 256, 257, 701, 1024, 1201, 1501]
    assert _att_units(full, 8) == 648
    assert _att_units([901], 8) == 120
    assert _att_units([0] + [100 + 190 * r for r in range(1, 8)], 32) == 3168
    assert _att_units(full * 2, 8) == 1296


@pytest.mark.parametrize("nb", [8, 16])
def test_accumulator_columns_are_batch_rows_and_terms(nb):
    """wgmma m64nNk16 with N = 3 NB: thread (warpgroup, warp, lane)'s
    element e is weight row 16 warp + lane / 4 + 8 ((e / 2) % 2) of its
    warpgroup's box and column 8 (e / 4) + 2 (lane % 4) + e % 2; column
    term * NB + b. The partial write takes e < NB / 2 (term 0) and adds
    e + NB / 2 and e + NB (terms 1, 2): every (batch row, tile row) once,
    and each from the same thread's three terms of the same b."""
    seen = np.zeros((nb, 128), np.int32)
    for cw in range(2):
        for warp in range(4):
            for lane in range(32):
                def col(e):
                    return 8 * (e >> 2) + 2 * (lane & 3) + (e & 1)

                def row(e):
                    return cw * 64 + 16 * warp + (lane >> 2) + 8 * ((e >> 1) & 1)
                for e in range(nb // 2):
                    b = col(e)
                    assert b < nb
                    assert col(e + nb // 2) == nb + b and col(e + nb) == 2 * nb + b
                    assert row(e + nb // 2) == row(e) == row(e + nb)
                    seen[b, row(e)] += 1
    assert seen.min() == 1 and seen.max() == 1


def _terms(v, n):
    out, r = [], v.clone()
    for _ in range(n):
        t = r.to(torch.bfloat16).float()
        out.append(t)
        r = r - t
    return out


def test_three_bf16_terms_hold_f32_exactly_two_within_2_16():
    """The kernel's split of an f32 activation v: hi = bf16(v), mid =
    bf16(v - hi), lo = bf16(v - hi - mid). Over values from 1e-30 to 1e30
    of both signs, hi + mid + lo == v bit for bit and |v - hi - mid| <=
    2**-16 |v|; the kernel's sums take them in the order lo + mid + hi."""
    g = torch.Generator().manual_seed(0)
    mant = torch.rand(200000, generator=g) + 0.5
    exps = torch.randint(-99, 100, (200000,), generator=g).float()
    sign = torch.where(torch.rand(200000, generator=g) < 0.5, -1.0, 1.0)
    v = (sign * mant * torch.pow(torch.tensor(10.0), exps / 3.3)).float()
    v = torch.cat([v, torch.tensor([0.0, 1.0, -3.0, 65504.0, 1e-30])])
    hi, mid, lo = _terms(v, 3)
    assert torch.equal((lo + mid) + hi, v)
    assert torch.equal(hi + mid + lo, v)
    two = hi + mid
    assert ((v - two).abs() <= 2.0 ** -16 * v.abs()).all()
    # one term alone (the rounding the kernel avoids) is off by up to 2**-9
    assert ((v - hi).abs() > 2.0 ** -12 * v.abs()).any()


@pytest.mark.parametrize("what", ["f32", "H % 8", "F % 8", "strided w",
                                  "int counts shape"])
def test_grouped_product_checks_raise(what):
    with FakeTensorMode():
        bf = torch.bfloat16
        x = torch.empty(2, 8, 16, dtype=bf, device="cuda")
        w = torch.empty(2, 16, 24, dtype=bf, device="cuda")
        counts = torch.empty(2, dtype=torch.int32, device="cuda")
        err = ValueError
        if what == "f32":
            x, w, err = x.float(), w.float(), TypeError
        elif what == "H % 8":
            x = torch.empty(2, 8, 12, dtype=bf, device="cuda")
            w = torch.empty(2, 12, 24, dtype=bf, device="cuda")
        elif what == "F % 8":
            w = torch.empty(2, 16, 20, dtype=bf, device="cuda")
        elif what == "strided w":
            # neither [E, H, F] nor the transpose of a contiguous [E, F, H]
            w = torch.empty(16, 2, 24, dtype=bf, device="cuda").transpose(0, 1)
        else:
            counts = torch.empty(3, dtype=torch.int32, device="cuda")
        with pytest.raises(err):
            mg.grouped_matmul(x, w, counts)


def _fake_layer(b=2, rep=2, d=64, hd=256, inter=512, h_kv=2, dtype=None):
    bf = dtype or torch.bfloat16
    h = h_kv * rep
    e = lambda *s, dt=bf: torch.empty(*s, dtype=dt, device="cuda")  # noqa: E731
    return [e(b, h, d), e(9, h_kv, 16, d), e(9, h_kv, 16, d),
            e(b, 4, dt=torch.int32), e(b, dt=torch.int32), e(b, hd),
            e(hd, h * d), e(hd), e(inter, hd), e(inter, hd), e(hd, inter),
            e(hd)]


@pytest.mark.parametrize("what", ["f32", "batch 17", "D 32", "block_i 12",
                                  "block_i 24", "strided", "rep 16"])
def test_decode_layer_checks_raise(what):
    with FakeTensorMode():
        kw = {}
        if what == "f32":
            args = _fake_layer(dtype=torch.float32)
        elif what == "batch 17":
            args = _fake_layer(b=17)
        elif what == "D 32":
            args = _fake_layer(d=32)
        elif what == "rep 16":
            args = _fake_layer(rep=16)
        else:
            args = _fake_layer()
            if what == "block_i 12":
                kw = dict(block_i=12)
            elif what == "block_i 24":
                kw = dict(block_i=24)
            else:
                args[5] = torch.empty(256, 2, dtype=torch.bfloat16,
                                      device="cuda").t()
        with pytest.raises(ValueError):
            dl.decode_layer(*args, **kw)
