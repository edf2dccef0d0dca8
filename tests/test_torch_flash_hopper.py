"""The Hopper flash-attention kernels (``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu``) as far as the CPU can hold them.

- The launches that ``flash_attention.ck_examples()`` declares: every
  element of out, lse, dq, dk, dv and delta is written by exactly one block,
  at every example and tail; each launch stays inside the card's 227 KB of
  shared memory a block and 1024 threads, the dk/dv kernel fits two blocks
  an SM, and the declared tiles, threads and stages are the sources' own.
- The wrapper's kernel-side checks raise on f32, non-contiguous operands
  and D 96 (on the card they run before any launch).
- The tensor cores take bf16: the forward feeds P to ``P V`` as two bf16
  terms (hi + lo, 16 significant bits), the backward rounds P and dS to
  bf16 once before the products that take them. A CPU model of that
  arithmetic (the plain version with P split and P, dS rounded) is held
  against ``flash_attention_pallas`` in interpret mode, which keeps them in
  f32, at several numpy seeds: the forward within the card's gate of one
  bf16 ulp of the largest output, the log-sum-exp within 1e-4, the backward
  within 1e-2 relative L2.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.kernels import flash_attention_pallas
from paddle_tpu_torch.analysis.kernels.resources import occupancy
from paddle_tpu_torch.cost_model import device_preset
from paddle_tpu_torch.ops.kernels import flash_attention as fa

CSRC = Path(fa.__file__).resolve().parents[2] / "csrc"
OUTPUTS = ("out", "lse", "dq", "dk", "dv", "delta")


def _examples():
    out = []
    for ex in fa.ck_examples():
        out += [ex, ex.tail]
    return out


@pytest.mark.parametrize("ex", _examples(), ids=lambda e: e.label)
def test_declared_writes_cover_each_output_element_once(ex):
    counts = {}
    for k in ex.kernels:
        for m in k.writes:
            c = counts.setdefault(m.operand, np.zeros(m.array_shape, np.int32))
            assert c.shape == m.array_shape, (m.operand, c.shape)
            for b in k.block_ids():
                for t in m.eval_index(b):
                    c[m.element_slices(t)] += 1
    outs = [op.name for op in ex.outputs]
    assert set(outs) <= set(OUTPUTS) and set(counts) == set(outs)
    for name, c in counts.items():
        assert c.min() == 1 and c.max() == 1, (name, c.min(), c.max())


@pytest.mark.parametrize("ex", _examples(), ids=lambda e: e.label)
def test_launches_fit_the_card(ex):
    preset = device_preset()
    for k in ex.kernels:
        assert k.smem <= preset["smem_per_block_optin"] <= 232448, k.kernel
        assert k.threads <= 1024 and k.threads % 128 == 0, k.kernel
        # the launch register counts ptxas gives (the setmaxnreg split
        # assumes them: 168 x 384 and 128 x 256)
        regs = {384: 168, 256: 128}.get(k.threads, 32)
        want = 2 if "dkv" in k.kernel else 1
        assert occupancy(k.threads, regs, k.smem, preset) >= want, k.kernel


def _constants(name):
    src = (CSRC / name).read_text()
    return {m.group(1): int(m.group(2)) for m in
            re.finditer(r"constexpr int (k\w+) = (\d+);", src)}, src


def test_declarations_match_the_sources():
    fwd, _ = _constants("flash_attention.cu")
    assert (fwd["kBQ"], fwd["kBK"], fwd["kStages"], fwd["kThreads"]) == \
        (fa._FWD_BQ, fa._FWD_BK, fa._FWD_STAGES, 384)
    bwd, src = _constants("flash_attention_bwd.cu")
    assert (bwd["kDqBQ"], bwd["kDqBK"], bwd["kDqStages"], bwd["kDqThreads"]) \
        == (fa._DQ_BQ, fa._DQ_BK, fa._DQ_STAGES, 384)
    assert (bwd["kKvBK"], bwd["kKvStages"], bwd["kKvThreads"]) == \
        (fa._KV_BK, fa._KV_STAGES, 256)
    assert bwd["kDeltaThreads"] == fa._DELTA_THREADS
    assert "kBQ = D == 128 ? 32 : 64;" in src
    assert (fa._kv_bq(128), fa._kv_bq(64)) == (32, 64)
    # D 128: the Q tile and two stages of 128-key K and V (160 KB); the dq
    # block's Q and dO with three stages of 64-key K and V (160 KB); the
    # dk/dv block's K and V with three stages of 32-query Q, dO, lse and
    # delta
    assert fa._fwd_smem(128) == 1024 + 32768 + 4 * 32768 + 40
    assert fa._dq_smem(128) == 1024 + 2 * 32768 + 6 * 16384 + 56
    assert fa._kv_smem(128) == 1024 + 2 * 16384 + 6 * 8192 + 768 + 56


@pytest.mark.parametrize("what,args", [
    ("f32", dict(dtype=torch.float32)),
    ("non-contiguous", dict(transpose=True)),
    ("D 96", dict(d=96))])
def test_kernel_checks_raise(what, args):
    d = args.get("d", 64)
    q = torch.zeros(1, 8, 2, d, dtype=args.get("dtype", torch.bfloat16))
    k = torch.zeros(1, 8, 2, d, dtype=q.dtype)
    if args.get("transpose"):
        k = torch.zeros(1, 2, 8, d, dtype=q.dtype).transpose(1, 2)
        assert not k.is_contiguous()
    err = TypeError if what == "f32" else ValueError
    with pytest.raises(err):
        fa._kernel_check("flash attention", (q, k, k), (None,))
    with pytest.raises(err):
        fa._kernel_check("flash attention backward", (q, k, k, q, q),
                         (torch.zeros(2, 8), None))


# -- the kernels' rounding of P and dS, modelled on the CPU ---------------------

def _bf16(t):
    return t.to(torch.bfloat16).float()


def _model(q, k, v, do, causal, seg):
    """The kernels' arithmetic on the CPU: f32 logits, probabilities and
    sums; P as bf16 hi + lo in ``P V``; P and dS rounded to bf16 before the
    backward's products; bf16 outputs."""
    b, s, h, d = q.shape
    h_kv = k.shape[2]
    rep = h // h_kv
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, s, h_kv, rep, d).permute(0, 2, 3, 1, 4)   # b g r s d
    kg = k.permute(0, 2, 1, 3)[:, :, None]                      # b g 1 t d
    vg = v.permute(0, 2, 1, 3)[:, :, None]
    dog = do.reshape(b, s, h_kv, rep, d).permute(0, 2, 3, 1, 4)
    logits = qg @ kg.transpose(-1, -2) * scale
    valid = fa._valid_mask(s, causal, seg, q.device)
    if valid is not None:
        logits = logits.masked_fill(~valid, fa.NEG_INF)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    if valid is not None:
        p = p.masked_fill(~valid, 0.0)
    l_safe = p.sum(-1, keepdim=True).clamp_min(1e-30)
    p_hi = _bf16(p)
    out_f = (p_hi @ vg + _bf16(p - p_hi) @ vg) / l_safe
    out = _bf16(out_f)
    lse = m + torch.log(l_safe)
    pn = p / l_safe                                  # exp(logits - lse)
    delta = (dog * out).sum(-1, keepdim=True)
    ds = pn * (dog @ vg.transpose(-1, -2) - delta)
    dq = _bf16(ds) @ kg * scale
    dk = (_bf16(ds).transpose(-1, -2) @ qg).sum(2) * scale
    dv = (_bf16(pn).transpose(-1, -2) @ dog).sum(2)

    def heads(t):
        return t.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)
    return (heads(out), lse[..., 0].reshape(b * h, s), _bf16(heads(dq)),
            _bf16(dk.permute(0, 2, 1, 3)), _bf16(dv.permute(0, 2, 1, 3)))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("b,s,h,h_kv,d,causal,with_seg,block", [
    (1, 128, 4, 2, 64, True, False, 128),
    (2, 64, 4, 1, 128, False, True, 64),
    (1, 192, 2, 2, 64, True, True, 64)])
def test_kernel_rounding_holds_the_gates_against_pallas(
        seed, b, s, h, h_kv, d, causal, with_seg, block):
    rng = np.random.default_rng(1000 * seed + s + d)

    def draw(*shape):   # bf16 values, as the kernels take them
        return _bf16(torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32))).numpy()

    q, do = draw(b, s, h, d), draw(b, s, h, d)
    k, v = draw(b, s, h_kv, d), draw(b, s, h_kv, d)
    seg = None
    if with_seg:
        seg = np.zeros((b, s), np.int32)
        seg[0, s // 3:], seg[-1, s // 2:] = 1, 2
    jseg = None if seg is None else jnp.asarray(seg)
    kw = dict(causal=causal, block_q=block, block_k=block, interpret=True,
              segment_ids=jseg)
    out_j, lse_j = flash_attention_pallas.flash_attention_forward_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    out, lse, dq, dk, dv = _model(
        *(torch.from_numpy(a) for a in (q, k, v, do)), causal,
        None if seg is None else torch.from_numpy(seg))
    ref = np.asarray(out_j)
    assert np.abs(out.numpy() - ref).max() <= 2.0 ** -7 * np.abs(ref).max()
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), rtol=1e-5,
                               atol=1e-4)
    # the backward from the model's own (bf16) forward output, as the card
    # runs it
    want = flash_attention_pallas.flash_attention_backward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(out.numpy()), lse_j, jnp.asarray(do), **kw)
    for name, a, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert _rel(a.numpy(), w) <= 1e-2, (name, _rel(a.numpy(), w))
