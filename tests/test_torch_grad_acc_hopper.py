"""The Hopper weight-gradient accumulation (row 21 of
``csrc/linear_grad_add.cu``: ``grad_acc_kernel``) as far as the CPU can
hold it.

- The launches that ``linear_grad_add.ck_examples()`` declares: every
  element of acc is written by exactly one block, at every example and
  tail (a cluster of ``split`` blocks sums one [256, 128] tile; block r of
  it writes rows r (256 / split) .. of it, and nothing past K); each
  launch stays inside the card's 227 KB of shared memory a block, 1024
  threads and a portable cluster of at most 8 blocks that divides the
  grid; one block an SM.
- The declared tile, threads, stages, split rule and shared memory are
  the source's own, and the plan takes each split (1, 2, 4, 8) at the
  path's shapes: the incubate path's four products at M 4096 and phase
  3's.
- The wrapper's kernel-side checks raise on f32 operands, K % 8, N % 8,
  an f16 or a strided accumulator (on fake CUDA tensors: nothing
  launches).
- The plain version, which the card tests hold the kernel to, against
  ``linear_grad_add_pallas.linear_grad_acc`` in interpret mode over M, K
  and N past the TPU kernel's tiles and both accumulator dtypes: f32
  within 1e-5 of the largest value (the same f32 products summed in
  another order), bf16 within one bf16 ulp of it (one rounding of that
  sum); the wrapper on CPU tensors updates acc in place, bit for bit the
  plain version.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from paddle_tpu.ops.kernels import linear_grad_add_pallas as jlga
from paddle_tpu_torch.cost_model import device_preset
from paddle_tpu_torch.ops.kernels import linear_grad_add as lga

SOURCE = Path(lga.__file__).resolve().parents[2] / "csrc" / "linear_grad_add.cu"


def _examples():
    return [e for ex in lga.ck_examples() for e in (ex, ex.tail)]


@pytest.mark.parametrize("ex", _examples(), ids=lambda e: e.label)
def test_declared_writes_cover_each_acc_element_once(ex):
    (k,) = ex.kernels
    (m,) = k.writes
    assert m.operand == "acc"
    c = np.zeros(m.array_shape, np.int32)
    for b in k.block_ids():
        for t in m.eval_index(b):
            c[m.element_slices(t)] += 1
    assert c.min() == 1 and c.max() == 1, (c.min(), c.max())


@pytest.mark.parametrize("ex", _examples(), ids=lambda e: e.label)
def test_launches_fit_the_card(ex):
    preset = device_preset()
    (k,) = ex.kernels
    assert k.smem <= preset["smem_per_block_optin"] == 232448, k.kernel
    assert k.threads <= 1024 and k.threads % 32 == 0, k.kernel
    split = k.cluster[0]
    assert k.cluster == (split, 1, 1) and split in (1, 2, 4, 8)
    assert k.grid[0] == split                     # one cluster a tile
    assert 2 * (k.smem + 1024) > 233472           # one block an SM


def _constants():
    src = SOURCE.read_text()
    return {m.group(1): int(m.group(2)) for m in
            re.finditer(r"constexpr int (k\w+) = (\d+);", src)}, src


def test_declarations_match_the_source():
    c, src = _constants()
    assert (c["kTK"], c["kTN"], c["kTM"], c["kThreads"], c["kStages"]) == \
        (lga._TK, lga._TN, lga._TM, lga._THREADS, lga._STAGES)
    assert (c["kSplit"], c["kSms"], c["kFixedSteps"]) == \
        (lga._SPLIT, lga._SMS, lga._FIXED_STEPS)
    # two consumer warpgroups of 128 output rows, then a producer warp
    assert lga._THREADS == 2 * 128 + 32 and lga._TK == 2 * 128
    assert "constexpr int kSmem = 1024 + kStages * kStageBytes + " \
        "2 * kStages * 8;" in src
    assert "kStageBytes = (kTK / 64 + kTN / 64) * kSub;" in src
    assert "constexpr int kSub = kTM * 128;" in src
    assert lga._SMEM == 1024 + 4 * 6 * 8192 + 64
    assert "    grad_acc_kernel(" in src
    assert "linear_grad_add_kernel" not in src
    # the split rule: waves times (steps + fixed), the smaller on a tie
    assert "(tiles * s + kSms - 1) / kSms * (cdiv(steps, s) + kFixedSteps)" \
        in src
    assert "for (int s = 1; s <= kSplit; s *= 2)" in src


@pytest.mark.parametrize("m,k,n,split", [
    (4096, 768, 2304, 2), (4096, 768, 768, 4), (4096, 768, 3072, 1),
    (4096, 3072, 768, 1), (8192, 768, 3072, 1), (4096, 4096, 14336, 1),
    (512, 1024, 2048, 2), (37, 136, 264, 1), (1000, 1800, 1000, 2),
    (2085, 264, 200, 8), (1, 8, 264, 1)])
def test_plans_at_the_path_shapes(m, k, n, split):
    """The incubate path's qkv and out products at B 4 x S 1024 split 2
    and 4 (108 and 72 blocks, one wave each), its fc and proj unsplit (72
    tiles already fill most of a wave: a split adds waves whose fixed
    cost outweighs the shorter sweeps); GPT-2's mlp.fc at M 8192 and
    Llama's gate (1792 tiles) unsplit; the tails at 1, 2 and 8."""
    got, grid, steps = lga._plan(m, k, n)
    assert got == split
    assert grid == (split, -(-k // 256), -(-n // 128))
    assert steps == -(-(-(-m // 64)) // split)       # 64-token steps a block


def test_split_rule_is_the_sources():
    """The split rule over a sweep of shapes, evaluated as the source
    writes it (C integer division), against the Python mirror."""
    def c_rule(m, k, n):
        def cdiv(a, b):
            return a // b + (a % b != 0)
        tiles, steps = cdiv(k, 256) * cdiv(n, 128), cdiv(m, 64)
        best, best_cost = 1, -1
        s = 1
        while s <= 8:
            cost = (tiles * s + 131) // 132 * (cdiv(steps, s) + 18)
            if best_cost < 0 or cost < best_cost:
                best, best_cost = s, cost
            s *= 2
        return best
    for m in (1, 63, 64, 1000, 4096, 8192, 32768):
        for k in (8, 256, 768, 3072, 4096):
            for n in (8, 128, 768, 2304, 14336):
                assert lga._split(m, k, n) == c_rule(m, k, n), (m, k, n)


@pytest.mark.parametrize("what", ["f32 x", "K % 8", "N % 8", "f16 acc",
                                  "strided acc"])
def test_kernel_checks_raise(what):
    with FakeTensorMode():
        x = torch.empty(4, 256, dtype=torch.bfloat16, device="cuda")
        dy = torch.empty(4, 64, dtype=torch.bfloat16, device="cuda")
        acc = torch.empty(256, 64, device="cuda")
        err = ValueError
        if what == "f32 x":
            x, err = x.float(), TypeError
        elif what == "K % 8":
            x = torch.empty(4, 252, dtype=torch.bfloat16, device="cuda")
            acc = torch.empty(252, 64, device="cuda")
        elif what == "N % 8":
            dy = torch.empty(4, 60, dtype=torch.bfloat16, device="cuda")
            acc = torch.empty(256, 60, device="cuda")
        elif what == "f16 acc":
            acc, err = acc.half(), TypeError
        else:
            acc = torch.empty(64, 256, device="cuda").t()
        before = lga.linear_grad_add.launches
        with pytest.raises(err):
            lga.linear_grad_add(x, dy, acc)
        assert lga.linear_grad_add.launches == before


@pytest.mark.parametrize("acc_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(1, 8, 16), (37, 24, 136), (130, 264, 16),
                                   (300, 64, 264)])
def test_plain_equals_jax_kernel(acc_dtype, m, k, n):
    rng = np.random.default_rng(m + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    dy = rng.standard_normal((m, n)).astype(np.float32)
    acc = (rng.standard_normal((k, n)) * 4).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if acc_dtype == "float32" \
        else (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(jlga.linear_grad_acc(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(dy, jnp.bfloat16),
        jnp.asarray(acc, jdt), interpret=True).astype(jnp.float32))
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tdy = torch.from_numpy(dy).to(torch.bfloat16)
    tacc = torch.from_numpy(acc).to(tdt)
    plain = lga.linear_grad_add_plain(tx, tdy, tacc.clone())
    got = lga.linear_grad_add(tx, tdy, tacc)
    assert got is tacc and torch.equal(got, plain)
    tol = 1e-5 if acc_dtype == "float32" else 2.0 ** -7
    err = np.abs(got.float().numpy() - want).max()
    assert err <= tol * np.abs(want).max(), err
