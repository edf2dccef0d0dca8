"""paddle_tpu_torch CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one. On the GPU:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerance: one bf16 ulp of the largest reference magnitude
(``2**-7 * max|ref|``) — kernel and plain version do the same f32
arithmetic and round once to bf16, in another order. The flash kernel
carries the probabilities into ``P V`` with 16 significant bits (a
two-term bf16 split), far inside that tolerance; its log-sum-exp is f32
and is held to 1e-4. The block epilogue's dropout mask is held exactly.
The decode layer's plain version rounds the attention output to bf16 once
more than the kernel, which keeps it in f32: its tolerance adds what that
rounding changes on the same inputs. The weight-only kernels sum exact
products in f32 and round once, as their plain versions do (one ulp); the
int8 ones return the same bits on two calls (no atomics).
The grouped expert product sums exact
bf16 products in f32 and rounds once, as its plain version does (one ulp),
and writes exact zeros past each expert's count. A8W8 is held bit for bit
where ``x / s`` is exact, and on random
activations to one ulp plus one quantisation step of a row (a rounding
tie may land on either side). The backward kernels: RMSNorm's dx and
SwiGLU's dg, du (two operands or one packed row) to one ulp, RMSNorm's
dw (an f32 sum over the rows in another order, then one rounding) to 1e-3
relative of its largest value; the block epilogue's dx and dres to one
ulp, its f32 dw and db to 1e-3 relative of their largest values;
flash attention's dq, dk, dv to 1e-2 relative L2 (the kernel feeds bf16
q, k, v, dO and P and dS rounded to bf16 to the tensor cores, the plain
version computes in f32; ``tests/test_torch_flash_hopper.py`` models that
rounding against the JAX kernel), and two backward calls bit for bit (no
atomics). The Hopper
building blocks (``csrc/hopper.cuh``: TMA, mbarriers, wgmma and their
descriptors, the proxy fence on a tile the threads write) are held on one
tile against ``torch.matmul`` in f32 to 1e-5 relative (exact bf16
products, f32 sums in another order); a 2-D TMA box exactly, zeros past
the tensor's edges. AdamW is held bit for bit: the kernel rounds each
operation on its own, as the plain version's tensor ops do. LAMB's moments
are held bit for bit too; its two norms are summed in another order, so
the trust ratio and the f32 weights are held to 1e-6 relative (of the
largest weight) and a bf16 parameter to one ulp. The cross-entropy row
statistics: the row max and the target logit exactly, the sum of
exponentials (another order, the fast exponential) to 1e-5 relative.
The incubate kernels: the masked softmax and its backward to one ulp; the
bias-dropout-residual layer norm's y, h, dx and dres to one ulp and its
f32 dgamma, dbeta and dbias to 1e-3 relative of their largest values;
dropout-add bit for bit (the same f32 product and sum, never contracted,
one rounding) with its dropped positions the counter hash's; the linear
weight-gradient accumulation into f32 to 1e-4 of the largest plain value
(f32 sums in another order) and into bf16 to one ulp.
"""

import pytest
import torch

from paddle_tpu_torch.models import gpt2_tiny, llama_tiny
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch import optimizer, regularizer
from paddle_tpu_torch.distributed import ParallelCrossEntropy
from paddle_tpu_torch.nn import clip
from paddle_tpu_torch.ops.kernels import WRAPPERS, a8w8_matmul, adamw, \
    autotune, bias_dropout_ln, block_epilogue, decode_layer, dropout_add, \
    flash_attention, lamb, linear_grad_add, mmha, moe_gemm, parallel_ce, \
    rms_norm, rope, softmax_mask, swiglu, wo_matmul
from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
from paddle_tpu_torch.models.qwen2_moe import _SwiGLU
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import LLMEngine, ServingConfig

pytestmark = pytest.mark.cuda

QUANT_KERNELS = ("wo_int8", "wo_int8_grouped", "wo_int4", "a8w8")
TRAIN_KERNELS = ("rms_norm_bwd", "swiglu_bwd", "flash_attention_bwd", "adamw",
                 "block_epilogue_bwd", "swiglu_packed", "swiglu_packed_bwd",
                 "lamb", "parallel_ce")
MOE_KERNELS = ("moe_gemm",)
INCUBATE_KERNELS = ("softmax_mask", "softmax_mask_tri", "softmax_mask_bwd",
                    "bias_dropout_ln", "bias_dropout_ln_bwd", "dropout_add",
                    "dropout_add_bwd", "linear_grad_add")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _randn(dev, *shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)


def _close(got, ref):
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 2.0 ** -7 * ref.float().abs().max().item(), err


@pytest.mark.parametrize("rows,hidden", [(1, 64), (3, 4096), (2, 12288),
                                         (300, 16384)])
@pytest.mark.parametrize("residual", [False, True])
def test_rms_norm_kernel(dev, rows, hidden, residual):
    x, w = _randn(dev, rows, hidden, seed=1), _randn(dev, hidden, seed=2)
    res = _randn(dev, rows, hidden, seed=3) if residual else None
    got = rms_norm.rms_norm(x, w, res, 1e-5)
    ref = rms_norm.rms_norm_plain(x, w, res, 1e-5)
    if residual:
        _close(got[1], ref[1])
        got, ref = got[0], ref[0]
    _close(got, ref)


@pytest.mark.parametrize("shape", [(3, 77), (5, 14336), (1, 5)])
def test_swiglu_kernel(dev, shape):
    g, u = _randn(dev, *shape, seed=4), _randn(dev, *shape, seed=5)
    _close(swiglu.swiglu(g, u), swiglu.swiglu_plain(g, u))


@pytest.mark.parametrize("shape,per_token", [((2, 5, 4, 64), False),
                                             ((3, 1, 8, 128), True),
                                             ((1, 7, 2, 16), False)])
def test_rope_kernel(dev, shape, per_token):
    b, s, _, d = shape
    rows = b * s if per_token else s
    ang = torch.rand(rows, d // 2, device=dev) * 6.3
    ang = torch.cat([ang, ang], dim=-1)
    x = _randn(dev, *shape, seed=6)
    _close(rope.rope_apply(x, ang.cos(), ang.sin()),
           rope.rope_plain(x, ang.cos(), ang.sin()))


def _tables(dev, lengths, ps, max_pages, seed=0):
    """Page tables handing out shuffled pages: row r holds lengths[r]
    positions (0: an inactive row, all trash). Returns (tables, pos,
    n_pages)."""
    need = [-(-n // ps) for n in lengths]
    n_pages = 1 + sum(need)
    g = torch.Generator().manual_seed(seed)
    perm = (torch.randperm(n_pages - 1, generator=g) + 1).tolist()
    tables = torch.zeros(len(lengths), max_pages, dtype=torch.int32)
    nxt = 0
    for r, k in enumerate(need):
        tables[r, :k] = torch.tensor(perm[nxt:nxt + k], dtype=torch.int32)
        nxt += k
    pos = torch.tensor([max(n - 1, 0) for n in lengths], dtype=torch.int32)
    return tables.to(dev), pos.to(dev), n_pages


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
def test_mmha_kernel(dev, d, rep):
    lengths, h_kv, ps = [1, 40, 0, 333, 16], 2, 16
    tables, pos, n_pages = _tables(dev, lengths, ps, 24)
    kp = _randn(dev, n_pages, h_kv, ps, d, seed=7)
    vp = _randn(dev, n_pages, h_kv, ps, d, seed=8)
    q = _randn(dev, len(lengths), 1, h_kv * rep, d, seed=9)
    got = mmha.mmha_decode(q, kp, vp, tables, pos)
    assert torch.isfinite(got).all()
    _close(got, mmha.mmha_plain(q, kp, vp, tables, pos))


@pytest.mark.parametrize("s", [1, 77, 200, 256])
@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_kernel(dev, s, rep, causal, d):
    """Ragged lengths (not multiples of the 64-row tile), GQA, causal and
    full, with the log-sum-exp."""
    b, h_kv = 2, 2
    q = _randn(dev, b, s, h_kv * rep, d, seed=10)
    k = _randn(dev, b, s, h_kv, d, seed=11)
    v = _randn(dev, b, s, h_kv, d, seed=12)
    got, lse = flash_attention.flash_attention(q, k, v, causal, None, True)
    ref, ref_lse = flash_attention.flash_attention_plain(q, k, v, causal,
                                                         None, True)
    assert torch.isfinite(got).all()
    _close(got, ref)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_segments(dev, causal):
    """Packed segments, including one-token segments (a query that sees
    only itself: every query sees its own key, so no row is ever fully
    masked through this interface)."""
    b, s, h, h_kv, d = 2, 150, 8, 2, 128
    seg = torch.zeros(b, s, dtype=torch.int32)
    seg[0, 40:] = 1
    seg[0, 41:] = 2
    seg[0, 100:] = 3
    seg[1, 1:] = 1
    seg[1, 149:] = 2
    seg = seg.to(dev)
    q = _randn(dev, b, s, h, d, seed=13)
    k = _randn(dev, b, s, h_kv, d, seed=14)
    v = _randn(dev, b, s, h_kv, d, seed=15)
    got, lse = flash_attention.flash_attention(q, k, v, causal, seg, True)
    ref, ref_lse = flash_attention.flash_attention_plain(q, k, v, causal, seg,
                                                         True)
    _close(got, ref)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)


EDGE_S = [1, 63, 64, 65, 127, 128, 129, 200]   # around the 64- and 128-row tiles


@pytest.mark.parametrize("s", EDGE_S)
@pytest.mark.parametrize("rep", [1, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_kernel_tile_edges(dev, s, rep, causal, d):
    """S at the edges of the forward's 128-query and 128-key tiles (the
    copies fill rows past S with zeros), GQA 1, 4 and 8, with the
    log-sum-exp."""
    b, h_kv = 1, 2
    q = _randn(dev, b, s, h_kv * rep, d, seed=60)
    k = _randn(dev, b, s, h_kv, d, seed=61)
    v = _randn(dev, b, s, h_kv, d, seed=62)
    got, lse = flash_attention.flash_attention(q, k, v, causal, None, True)
    ref, ref_lse = flash_attention.flash_attention_plain(q, k, v, causal,
                                                         None, True)
    assert torch.isfinite(got).all()
    _close(got, ref)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("s", [65, 129, 300])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_kernel_segments_tile_edges(dev, s, causal, d):
    """Segments whose cuts fall inside and on the edges of the tiles."""
    b, h, h_kv = 2, 8, 1
    seg = flash_attention.segment_ids(
        s, [[1, 63, 64, s - 1], [s // 2, s // 2 + 1]]).to(dev)
    q = _randn(dev, b, s, h, d, seed=63)
    k = _randn(dev, b, s, h_kv, d, seed=64)
    v = _randn(dev, b, s, h_kv, d, seed=65)
    got, lse = flash_attention.flash_attention(q, k, v, causal, seg, True)
    ref, ref_lse = flash_attention.flash_attention_plain(q, k, v, causal, seg,
                                                         True)
    _close(got, ref)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)


EPI_CASES = [(None, "rms", 0.0, False), (None, "rms", 0.1, False),
             (None, "layer", 0.0, True), (None, "layer", 0.3, False),
             ("gelu", "rms", 0.0, False), ("gelu", "layer", 0.2, True),
             ("swiglu", "rms", 0.0, False), ("swiglu", "layer", 0.4, True)]


@pytest.mark.parametrize("act,norm,p,bias_on", EPI_CASES)
@pytest.mark.parametrize("rows,hidden", [(1, 64), (37, 4096), (5, 12288)])
def test_block_epilogue_kernel(dev, act, norm, p, bias_on, rows, hidden):
    xw = 2 * hidden if act == "swiglu" else hidden
    x = _randn(dev, rows, xw, seed=16)
    res = _randn(dev, rows, hidden, seed=17)
    w = _randn(dev, hidden, seed=18)
    bias = _randn(dev, hidden, seed=19) if bias_on else None
    args = (x, res, w, bias, 1234, p, 1e-5, act, norm)
    got = block_epilogue.fused_epilogue(*args)
    ref = block_epilogue.fused_epilogue_plain(*args)
    _close(got[1], ref[1])
    _close(got[0], ref[0])
    if p:
        # with a zero residual and x bounded away from 0 (randn can give an
        # exact 0), h is 0 exactly where the mask dropped
        x1 = (x.float().abs() + 1.0).to(x.dtype)
        _, h0 = block_epilogue.fused_epilogue(x1, torch.zeros_like(res), w,
                                              bias, 1234, p, 1e-5, act, norm)
        keep = block_epilogue.keep_mask(rows, hidden, 1234, p, dev)
        assert torch.equal(h0 == 0, ~keep)


def test_kernels_reject_what_they_do_not_take(dev):
    x = torch.zeros(2, 64, device=dev)                    # f32 on the card
    with pytest.raises(TypeError):
        rms_norm.rms_norm(x, torch.ones(64, device=dev))
    with pytest.raises(TypeError):
        block_epilogue.fused_epilogue(x, x, torch.ones(64, device=dev))
    with pytest.raises(ValueError):                       # D = 32: no kernel
        mmha.mmha_decode(_randn(dev, 1, 1, 2, 32), _randn(dev, 2, 1, 4, 32),
                         _randn(dev, 2, 1, 4, 32),
                         torch.ones(1, 1, dtype=torch.int32, device=dev),
                         torch.zeros(1, dtype=torch.int32, device=dev))
    q = _randn(dev, 1, 8, 2, 32)
    with pytest.raises(ValueError):                       # D = 32: no kernel
        flash_attention.flash_attention(q, q, q)


@pytest.mark.parametrize("what", ["f32", "non-contiguous", "D 96"])
def test_flash_kernels_reject_what_they_do_not_take(dev, what):
    d = 96 if what == "D 96" else 64
    q = _randn(dev, 1, 64, 4, d)
    k = _randn(dev, 1, 64, 2, d)
    if what == "f32":
        q, k = q.float(), k.float()
    if what == "non-contiguous":
        k = _randn(dev, 1, 2, 64, d).transpose(1, 2)
    err = TypeError if what == "f32" else ValueError
    before = (flash_attention.flash_attention.launches,
              flash_attention.flash_attention_bwd.launches)
    with pytest.raises(err):
        flash_attention.flash_attention(q, k, k, True)
    lse = torch.zeros(4, 64, device=dev)
    with pytest.raises(err):
        flash_attention.flash_attention_bwd(q, k, k, q, lse, q, True)
    assert before == (flash_attention.flash_attention.launches,
                      flash_attention.flash_attention_bwd.launches)


def test_engine_runs_every_kernel(dev):
    """The default ``ServingConfig()`` (monolithic prefill, fused blocks,
    prefix cache) launches all six kernels."""
    model = llama_tiny(device=dev, dtype=torch.bfloat16, hidden_size=256,
                       num_heads=4, num_kv_heads=2, intermediate_size=512)
    for w in WRAPPERS.values():
        w.launches = 0
    eng = LLMEngine(model, ServingConfig(page_size=16, num_pages=33,
                                         max_batch=2, max_new_tokens=8,
                                         dtype="bfloat16"))
    try:
        reqs = [eng.submit(list(range(1 + i, 60 + i))) for i in range(3)]
        outs = [r.result(timeout=300) for r in reqs]
    finally:
        summary = eng.shutdown()
    assert all(len(o) == 8 for o in outs)
    assert summary["pages_leaked"] == 0
    off_path = ("decode_layer",) + QUANT_KERNELS + TRAIN_KERNELS + \
        MOE_KERNELS + INCUBATE_KERNELS
    assert all(w.launches > 0 for n, w in WRAPPERS.items()
               if n not in off_path)
    assert all(WRAPPERS[n].launches == 0 for n in off_path)  # not on this path


def _layer(dev, b, rep, d, h_kv=2, hd=256, inter=512, ps=16, seed=20):
    lengths = [0] + [1 + (97 * r) % 300 for r in range(1, b)] if b > 1 \
        else [77]
    tables, pos, n_pages = _tables(dev, lengths, ps, 24, seed)
    h = h_kv * rep
    norm = (1 + 0.1 * _randn(dev, hd, seed=seed + 1).float()).to(torch.bfloat16)
    w = lambda *s, k: (_randn(dev, *s, seed=seed + k).float() * 0.05).to(  # noqa: E731
        torch.bfloat16)
    return (_randn(dev, b, h, d, seed=seed + 2),
            _randn(dev, n_pages, h_kv, ps, d, seed=seed + 3),
            _randn(dev, n_pages, h_kv, ps, d, seed=seed + 4), tables, pos,
            _randn(dev, b, hd, seed=seed + 5), w(hd, h * d, k=6), norm,
            w(inter, hd, k=7), w(inter, hd, k=8), w(hd, inter, k=9), norm)


def _layer_tol(args, ref_y, ref_h):
    """(tol_y, tol_h): one bf16 ulp of the largest reference value plus
    what the plain version's extra bf16 rounding of the attention output
    changes (the plain version with an f32 query keeps it in f32)."""
    y32, h32 = decode_layer.decode_layer_plain(args[0].float(), *args[1:],
                                               1e-5, 1e-5)
    return tuple(2.0 ** -7 * ref.float().abs().max().item()
                 + (ref.float() - r32.float()).abs().max().item()
                 for ref, r32 in ((ref_y, y32), (ref_h, h32)))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
@pytest.mark.parametrize("b", [1, 5, 16])
def test_decode_layer_kernel(dev, d, rep, b):
    """Against the plain version at every legal block_i; two calls give the
    same bits; the inactive row (position 0, all-trash table) is finite."""
    args = _layer(dev, b, rep, d)
    ref_y, ref_h = decode_layer.decode_layer_plain(*args, 1e-5, 1e-5)
    tol_y, tol_h = _layer_tol(args, ref_y, ref_h)
    for block_i in autotune._block_i_candidates(512):
        y, h = decode_layer.decode_layer(*args, 1e-5, 1e-5, block_i=block_i)
        torch.cuda.synchronize()
        assert torch.isfinite(y).all() and torch.isfinite(h).all()
        assert (y.float() - ref_y.float()).abs().max().item() <= tol_y
        assert (h.float() - ref_h.float()).abs().max().item() <= tol_h
        y2, h2 = decode_layer.decode_layer(*args, 1e-5, 1e-5, block_i=block_i)
        assert torch.equal(y, y2) and torch.equal(h, h2)


def test_decode_layer_deterministic_at_every_block_i(dev):
    """B 8 (the wgmma's N 8) at a width where every tile is split over
    several blocks (hidden 2048, I 5632, H 16 over Hkv 4, D 128, rows up to
    300 positions): every legal block_i gives the same bits as the first,
    within the tolerance of the plain version."""
    args = _layer(dev, 8, 4, 128, h_kv=4, hd=2048, inter=5632)
    ref_y, ref_h = decode_layer.decode_layer_plain(*args, 1e-5, 1e-5)
    tol_y, tol_h = _layer_tol(args, ref_y, ref_h)
    first = None
    for block_i in autotune._block_i_candidates(5632):
        y, h = decode_layer.decode_layer(*args, 1e-5, 1e-5, block_i=block_i)
        torch.cuda.synchronize()
        assert (y.float() - ref_y.float()).abs().max().item() <= tol_y
        assert (h.float() - ref_h.float()).abs().max().item() <= tol_h
        if first is None:
            first = (y, h)
        assert torch.equal(y, first[0]) and torch.equal(h, first[1])


@pytest.mark.parametrize("b", [9, 16])
def test_decode_layer_wide_batch(dev, b):
    """Batch past 8 takes the wgmma's N 16 (one pass over the weights):
    against the plain version at hidden 2048, I 5632, two calls alike."""
    args = _layer(dev, b, 4, 128, h_kv=4, hd=2048, inter=5632)
    ref_y, ref_h = decode_layer.decode_layer_plain(*args, 1e-5, 1e-5)
    tol_y, tol_h = _layer_tol(args, ref_y, ref_h)
    y, h = decode_layer.decode_layer(*args, 1e-5, 1e-5)
    torch.cuda.synchronize()
    assert (y.float() - ref_y.float()).abs().max().item() <= tol_y
    assert (h.float() - ref_h.float()).abs().max().item() <= tol_h
    y2, h2 = decode_layer.decode_layer(*args, 1e-5, 1e-5)
    assert torch.equal(y, y2) and torch.equal(h, h2)


@pytest.mark.parametrize("b,h_kv,rep,d,hd,inter", [
    (1, 8, 4, 128, 4096, 14336), (8, 8, 4, 128, 4096, 14336),
    (16, 8, 4, 128, 4096, 14336), (3, 4, 2, 64, 520, 1040)])
def test_decode_layer_scratch_matches_its_mirror(dev, b, h_kv, rep, d, hd,
                                                 inter):
    """The C entry's scratch and counter counts equal the Python mirrors
    the analyzer's declarations use, on this card's SM count."""
    import ctypes
    from paddle_tpu_torch.ops.kernels import _build
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert decode_layer.scratch_floats(b, h_kv, rep, d, hd, inter) == \
        decode_layer._scratch_floats(b, h_kv, rep, d, hd, inter, sms)
    ctrl = _build.function("decode_layer", "ptt_decode_layer_ctrl",
                           [ctypes.c_int] * 4)
    assert ctrl(b, h_kv, hd, inter) == decode_layer.ctrl_words(b, h_kv, hd,
                                                              inter)


def test_decode_layer_leaves_its_counters_zero(dev):
    """The counters the kernel keeps for its stream are zero after a call
    (the last block clears them), so the next call starts clean."""
    args = _layer(dev, 8, 4, 128, h_kv=4, hd=2048, inter=5632)
    decode_layer.decode_layer(*args, 1e-5, 1e-5)
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream(dev).cuda_stream
    buf = decode_layer._CTRLS[(dev.index, stream)]
    assert not buf.any()


def test_decode_layer_rejects_what_it_does_not_take(dev):
    args = _layer(dev, 2, 2, 64)
    with pytest.raises(ValueError):                       # f32 activations
        decode_layer.decode_layer(*[a.float() if a.is_floating_point() else a
                                    for a in args])
    with pytest.raises(ValueError):                       # block_i 12
        decode_layer.decode_layer(*args, block_i=12)
    with pytest.raises(ValueError):                       # block_i 24 ∤ 512
        decode_layer.decode_layer(*args, block_i=24)
    with pytest.raises(ValueError):                       # batch 17
        big = _layer(dev, 17, 2, 64)
        decode_layer.decode_layer(*big)
    with pytest.raises(ValueError):                       # D = 32
        a = list(_layer(dev, 2, 2, 64, hd=128))
        a[0] = _randn(dev, 2, 4, 32)
        a[1] = a[2] = _randn(dev, a[1].shape[0], 2, 16, 32)
        decode_layer.decode_layer(*a)
    with pytest.raises(ValueError):                       # not contiguous
        a = list(args)
        a[5] = torch.cat([a[5], a[5]], 1)[:, ::2]
        decode_layer.decode_layer(*a)


def test_fused_layer_engine_runs_only_the_decode_layer(dev, monkeypatch,
                                                       tmp_path):
    """``fused_decode_layer=True``: the construction tunes block_i (a
    second construction hits the cache), every decode step launches the
    decode layer once per layer and mmha never."""
    monkeypatch.setenv("PADDLE_TPU_TUNE_CACHE", str(tmp_path / "tc.json"))
    model = llama_tiny(device=dev, dtype=torch.bfloat16, hidden_size=256,
                       num_heads=4, num_kv_heads=2, intermediate_size=512)
    cfg = ServingConfig(fused_decode_layer=True, page_size=16, num_pages=33,
                        max_batch=2, max_new_tokens=8, dtype="bfloat16")
    eng = LLMEngine(model, cfg)
    assert eng.tuning is not None and eng.tuning["block_i"] in (
        512, 256, 128, 64, 32, 16, 8)
    for w in WRAPPERS.values():
        w.launches = 0
    try:
        reqs = [eng.submit(list(range(1 + i, 60 + i))) for i in range(3)]
        outs = [r.result(timeout=300) for r in reqs]
        steps = eng.stats()["decode_steps"]
    finally:
        summary = eng.shutdown()
    assert all(len(o) == 8 for o in outs)
    assert summary["pages_leaked"] == 0
    assert WRAPPERS["decode_layer"].launches == 2 * steps > 0
    assert WRAPPERS["mmha"].launches == 0
    cache = autotune.default_cache()
    hits = cache.hits
    eng2 = LLMEngine(model, cfg)
    eng2.shutdown()
    assert cache.hits == hits + 1 and eng2.tuning == eng.tuning


def test_fused_layer_engine_refuses_what_the_kernel_does_not_take(dev):
    model = llama_tiny(device=dev, dtype=torch.bfloat16, hidden_size=256,
                       num_heads=4, num_kv_heads=2, intermediate_size=512)
    with pytest.raises(ValueError):                       # batch 17
        LLMEngine(model, ServingConfig(fused_decode_layer=True, max_batch=17,
                                       dtype="bfloat16"))
    with pytest.raises(ValueError):                       # f32 pool
        LLMEngine(model, ServingConfig(fused_decode_layer=True))
    with pytest.raises(ValueError):                       # per-op path
        LLMEngine(model, ServingConfig(fused_decode_layer=True,
                                       fused_block=False, dtype="bfloat16"))


# -- quantized products -------------------------------------------------------

def _int8(dev, *shape, seed=0, lo=-127, hi=128):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(lo, hi, shape, generator=g, device=dev,
                         dtype=torch.int8)


def _scales(dev, *shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand(shape, generator=g, device=dev) * 0.02 + 0.001


# (K, N): Llama-3-8B's widths, and widths off every tile multiple the
# kernels take (K not a multiple of the 64 / 256 k-tile, N not a multiple
# of the 32 / 128 column tile)
_WO_SHAPES = [(4096, 1024), (1000, 1056), (264, 2080)]
# rows on both sides of the decode / prefill switch (16), of the prefill
# kernels' 64-row wgmma tiles and of their 128- and 256-row block tiles
_ROWS = [1, 5, 8, 16, 17, 63, 64, 65, 128, 129, 255, 257, 1531]
# (K, N, kind, G): every group size of 1, 3, 8, 24, 128 that divides K
_WO_CASES = [(k, n, kind, g) for k, n in _WO_SHAPES
             for kind, g in [("int8", None), ("int4", None)]
             + [("int8_grouped", g) for g in (1, 3, 8, 24, 128)]
             if g is None or k % g == 0]


@pytest.mark.parametrize("m", _ROWS)
@pytest.mark.parametrize("k,n,kind,group", _WO_CASES)
def test_wo_kernels(dev, m, k, n, kind, group):
    """Each weight-only kernel against its plain version: the same f32
    sums of exact products, rounded once (one bf16 ulp of the largest
    reference value)."""
    x = _randn(dev, m, k, seed=m)
    if kind == "int4":
        w = _int8(dev, k, n // 2, seed=1, lo=-128)
        s = _scales(dev, n, seed=2)
        got, ref = wo_matmul.wo_int4(x, w, s), \
            wo_matmul.wo_int4_matmul_plain(x, w, s)
    else:
        w = _int8(dev, k, n, seed=1)
        s = _scales(dev, k // group, n, seed=2) if kind == "int8_grouped" \
            else _scales(dev, n, seed=2)
        fn = wo_matmul.wo_int8_grouped if kind == "int8_grouped" \
            else wo_matmul.wo_int8
        got, ref = fn(x, w, s), wo_matmul.wo_int8_matmul_plain(x, w, s)
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    _close(got, ref)


@pytest.mark.parametrize("m,k,n,group", [
    (m, k, n, g) for m, k, n in ((1, 4096, 1024), (8, 14336, 4096),
                                 (8, 4096, 14336), (16, 264, 2080),
                                 (1531, 4096, 1024))
    for g in (None, 8, 128) if g is None or k % g == 0])
def test_wo_int8_kernels_are_deterministic(dev, m, k, n, group):
    """Two calls return the same bits: the decode kernel splits K over a
    cluster's blocks and adds their partial sums in rank order, never with
    atomics; the prefill kernel sums each tile in one block. Llama-3-8B's
    decode shapes give each decode block two windows of x, the last one
    ending inside its K slice."""
    x, w = _randn(dev, m, k, seed=7), _int8(dev, k, n, seed=8)
    s = _scales(dev, n, seed=9) if group is None \
        else _scales(dev, k // group, n, seed=9)
    fn = wo_matmul.wo_int8 if group is None else wo_matmul.wo_int8_grouped
    first, second = fn(x, w, s), fn(x, w, s)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))
    _close(first, wo_matmul.wo_int8_matmul_plain(x, w, s))


# int4: both decode shapes, a 16-token decode, a decode and a prefill whose
# N/2 (528) ends inside a tile's 64 bytes, the ragged prefill
_INT4_SHAPES = [(8, 4096, 14336), (8, 14336, 4096), (16, 264, 2080),
                (5, 1032, 1056), (37, 1032, 1056), (1531, 4096, 1024)]


@pytest.mark.parametrize("m,k,n", _INT4_SHAPES)
def test_wo_int4_kernels_are_deterministic(dev, m, k, n):
    """Two calls of the int4 kernels return the same bits (the decode
    kernel's cluster K split adds its partials in rank order), within one
    bf16 ulp of the plain version."""
    x = _randn(dev, m, k, seed=7)
    w, s = _int8(dev, k, n // 2, seed=8, lo=-128), _scales(dev, n, seed=9)
    first, second = wo_matmul.wo_int4(x, w, s), wo_matmul.wo_int4(x, w, s)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))
    _close(first, wo_matmul.wo_int4_matmul_plain(x, w, s))


@pytest.mark.parametrize("m,k,n,cols", [
    (8, 4096, 14336, 256), (16, 4096, 14336, 256), (5, 264, 8480, 256),
    (8, 14336, 4096, 128), (16, 264, 2080, 128), (5, 1032, 1056, 128)])
def test_wo_int4_decode_widths(dev, cols, m, k, n):
    """Both widths of the int4 decode tile (a 64- or a 128-byte box of
    packed bytes a row), each at shapes the plan gives it (N/2 = 4240,
    1040 and 528 end inside a box), against the plain version, twice the
    same bits."""
    assert wo_matmul._int4_dec_cols(m, n) == cols
    x = _randn(dev, m, k, seed=10)
    w, s = _int8(dev, k, n // 2, seed=11, lo=-128), _scales(dev, n, seed=12)
    first, second = wo_matmul.wo_int4(x, w, s), wo_matmul.wo_int4(x, w, s)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))
    _close(first, wo_matmul.wo_int4_matmul_plain(x, w, s))


def test_wo_matmul_leading_dims_and_counts(dev):
    x = _randn(dev, 2, 3, 256, seed=3)
    w = _int8(dev, 256, 64, seed=4)
    s = _scales(dev, 64, seed=5)
    for wr in WRAPPERS.values():
        wr.launches = 0
    got = wo_matmul.wo_int8_matmul(x, w, s)
    _close(got, wo_matmul.wo_int8_matmul_plain(x, w, s))
    wo_matmul.wo_int8_matmul(x, w, _scales(dev, 4, 64, seed=6))
    packed = wo_matmul.pack_int4_halves(_int8(dev, 256, 64, seed=7, lo=-7,
                                              hi=8))
    out4 = wo_matmul.wo_int4_matmul(x, packed, s)
    assert got.shape == out4.shape == (2, 3, 64)
    assert (WRAPPERS["wo_int8"].launches, WRAPPERS["wo_int8_grouped"].launches,
            WRAPPERS["wo_int4"].launches) == (1, 1, 1)


def test_wo_kernels_reject_what_they_do_not_take(dev):
    x, w, s = _randn(dev, 4, 256), _int8(dev, 256, 64), _scales(dev, 64)
    with pytest.raises(ValueError):                       # f32 activations
        wo_matmul.wo_int8(x.float(), w, s)
    with pytest.raises(ValueError):                       # K % 8
        wo_matmul.wo_int8(_randn(dev, 4, 252), _int8(dev, 252, 64), s)
    with pytest.raises(ValueError):                       # N % 16
        wo_matmul.wo_int8(x, _int8(dev, 256, 72), _scales(dev, 72))
    with pytest.raises(ValueError):                       # int4: N % 32
        wo_matmul.wo_int4(x, _int8(dev, 256, 24), _scales(dev, 48))
    with pytest.raises(ValueError):                       # not int8
        wo_matmul.wo_int8_matmul(x, w.float(), s)


def _pinned(dev, m, k, seed=0):
    """x = q * 2**-5 with integer q in [-127, 127] and |q| = 127 pinned in
    column 0, so s = 2**-5 exactly and x / s has no rounding at all."""
    q = _int8(dev, m, k, seed=seed).float()
    q[:, 0] = 127.0
    return (q * 2.0 ** -5).to(torch.bfloat16)


@pytest.mark.parametrize("m", _ROWS)
@pytest.mark.parametrize("layout", ["kn", "nk"])
def test_a8w8_kernel_bit_identical_on_pinned_construction(dev, m, layout):
    k, n = 384, 272
    x = _pinned(dev, m, k, seed=m)
    w = _int8(dev, k, n, seed=2)
    ws = _scales(dev, n, seed=3)
    wl = w.t().contiguous() if layout == "nk" else w
    got = a8w8_matmul.a8w8_matmul(x, wl, ws, layout)
    ref = a8w8_matmul.a8w8_matmul_plain(x, wl, ws, layout)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("m", _ROWS)
@pytest.mark.parametrize("k,n", [(4096, 1024), (1008, 1040), (272, 200)])
def test_a8w8_kernel_random(dev, m, k, n):
    """Random activations: the quantized q may differ where x / s lands
    within rounding of a half, so the tolerance is one bf16 ulp of the
    largest reference value plus one quantisation step of the row."""
    x = _randn(dev, m, k, seed=m)
    w = _int8(dev, n, k, seed=2)
    ws = _scales(dev, n, seed=3)
    got = a8w8_matmul.a8w8_matmul(x, w, ws, "nk")
    ref = a8w8_matmul.a8w8_matmul_plain(x, w, ws, "nk")
    _, s = a8w8_matmul.row_quantize(x)
    step = (s * 127.0 * ws.max()).max().item()
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 2.0 ** -7 * ref.float().abs().max().item() + step, err


def test_a8w8_rejects_what_it_does_not_take(dev):
    w, ws = _int8(dev, 64, 256), _scales(dev, 64)
    with pytest.raises(ValueError):                       # f32 activations
        a8w8_matmul.a8w8_matmul(torch.zeros(4, 256, device=dev), w, ws, "nk")
    with pytest.raises(ValueError):                       # K % 16
        a8w8_matmul.a8w8_matmul(_randn(dev, 4, 248), _int8(dev, 64, 248), ws,
                                "nk")
    with pytest.raises(ValueError):                       # kn: N % 16
        a8w8_matmul.a8w8_matmul(_randn(dev, 4, 256), _int8(dev, 256, 40),
                                _scales(dev, 40), "kn")


# (M, K, N): several waves of 128 x 256 tiles (the llm_int8 prefill: 448
# tiles on 132 SMs), and tails past every tile edge (M 37, K 1040 = 8 k-steps
# and 16 bytes, N 1008 = 3 column tiles and 240)
_A8W8_SHAPES = [(1024, 4096, 14336), (300, 1040, 1008), (37, 1040, 1008)]


@pytest.mark.parametrize("m,k,n", _A8W8_SHAPES)
@pytest.mark.parametrize("layout", ["kn", "nk"])
def test_a8w8_kernel_waves_and_tails(dev, m, k, n, layout):
    """Bit-identical on the pinned construction and within one bf16 ulp of
    the largest value plus a quantisation step on random activations, in
    both layouts ("kn" through its K-major copy)."""
    w = _int8(dev, n, k, seed=4)
    ws = _scales(dev, n, seed=5)
    wl = w if layout == "nk" else w.t().contiguous()
    x = _pinned(dev, m, k, seed=6)
    got = a8w8_matmul.a8w8_matmul(x, wl, ws, layout)
    ref = a8w8_matmul.a8w8_matmul_plain(x, wl, ws, layout)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    x = _randn(dev, m, k, seed=7)
    got = a8w8_matmul.a8w8_matmul(x, wl, ws, layout)
    ref = a8w8_matmul.a8w8_matmul_plain(x, wl, ws, layout)
    _, s = a8w8_matmul.row_quantize(x)
    step = (s * 127.0 * ws.max()).max().item()
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 2.0 ** -7 * ref.float().abs().max().item() + step, err


@pytest.mark.parametrize("m,k,n", _A8W8_SHAPES[:2])
@pytest.mark.parametrize("layout", ["kn", "nk"])
def test_a8w8_kernel_is_deterministic(dev, m, k, n, layout):
    w = _int8(dev, n, k, seed=8)
    wl = w if layout == "nk" else w.t().contiguous()
    ws = _scales(dev, n, seed=9)
    x = _randn(dev, m, k, seed=10)
    a = a8w8_matmul.a8w8_matmul(x, wl, ws, layout)
    b = a8w8_matmul.a8w8_matmul(x, wl, ws, layout)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("quant,group,fused,kernel", [
    ("weight_only_int8", -1, False, "wo_int8"),
    ("weight_only_int4", -1, False, "wo_int4"),
    ("weight_only_int8", 64, True, "wo_int8_grouped"),
])
def test_quant_engine_launches_a_wo_kernel_per_projection(
        dev, monkeypatch, tmp_path, quant, group, fused, kernel):
    """A quant engine runs each of the 7 projections of every layer through
    its weight-only kernel once per forward (on the fused-layer engine: all
    7 in prefill, q/k/v in decode, where the decode layer takes the rest)."""
    monkeypatch.setenv("PADDLE_TPU_TUNE_CACHE", str(tmp_path / "tc.json"))
    model = llama_tiny(device=dev, dtype=torch.bfloat16, hidden_size=256,
                       num_heads=4, num_kv_heads=2, intermediate_size=512)
    eng = LLMEngine(model, ServingConfig(
        page_size=16, num_pages=33, max_batch=2, max_new_tokens=8,
        dtype="bfloat16", quant=quant, quant_group_size=group,
        fused_decode_layer=fused))
    for w in WRAPPERS.values():
        w.launches = 0
    try:
        reqs = [eng.submit(list(range(1 + i, 60 + i))) for i in range(3)]
        outs = [r.result(timeout=300) for r in reqs]
        prefills = len(eng.prefill_ms) + len(eng.chunk_ms)
        steps = len(eng.step_ms)
    finally:
        summary = eng.shutdown()
    assert all(len(o) == 8 for o in outs) and summary["pages_leaked"] == 0
    layers = model.cfg.num_layers
    per_step = 3 if fused else 7
    assert WRAPPERS[kernel].launches == layers * (7 * prefills
                                                  + per_step * steps) > 0
    assert all(WRAPPERS[n].launches == 0 for n in QUANT_KERNELS
               if n != kernel)
    assert WRAPPERS["decode_layer"].launches == (layers * steps if fused
                                                 else 0)


# -- training kernels ------------------------------------------------------------

def _rel_l2(got, ref):
    torch.cuda.synchronize()
    return ((got.float() - ref.float()).norm() / ref.float().norm()).item()


@pytest.mark.parametrize("rows,hidden", [(1, 64), (37, 4096), (300, 8192),
                                         (5, 2056)])
@pytest.mark.parametrize("residual", [False, True])
def test_rms_norm_bwd_kernel(dev, rows, hidden, residual):
    h, g = _randn(dev, rows, hidden, seed=30), _randn(dev, rows, hidden, seed=31)
    w = (1.0 + 0.1 * _randn(dev, hidden, seed=32).float()).to(torch.bfloat16)
    g_h = _randn(dev, rows, hidden, seed=33) if residual else None
    dx, dw = rms_norm.rms_norm_bwd(h, w, g, g_h, 1e-5)
    rdx, rdw = rms_norm.rms_norm_bwd_plain(h, w, g, g_h, 1e-5)
    _close(dx, rdx)
    err = (dw.float() - rdw.float()).abs().max().item()
    assert err <= 1e-3 * rdw.float().abs().max().item() + 2.0 ** -7 * \
        rdw.float().abs().max().item(), err


@pytest.mark.parametrize("shape", [(3, 77), (5, 14336), (1, 5)])
def test_swiglu_bwd_kernel(dev, shape):
    g, u = _randn(dev, *shape, seed=34), _randn(dev, *shape, seed=35)
    dy = _randn(dev, *shape, seed=36)
    dg, du = swiglu.swiglu_bwd(g, u, dy)
    rdg, rdu = swiglu.swiglu_bwd_plain(g, u, dy)
    _close(dg, rdg)
    _close(du, rdu)


FLASH_BWD_CASES = [
    # b, s, h, h_kv, d, causal, segments
    (1, 128, 4, 2, 64, True, False),
    (2, 200, 8, 2, 128, True, True),
    (1, 77, 4, 4, 128, False, False),
    (2, 256, 8, 1, 64, False, True),
    (1, 1, 2, 1, 128, True, False),
    (1, 300, 16, 2, 128, True, False),
]


@pytest.mark.parametrize("b,s,h,h_kv,d,causal,with_seg", FLASH_BWD_CASES)
def test_flash_attention_bwd_kernel(dev, b, s, h, h_kv, d, causal, with_seg):
    q, do = _randn(dev, b, s, h, d, seed=37), _randn(dev, b, s, h, d, seed=38)
    k, v = _randn(dev, b, s, h_kv, d, seed=39), _randn(dev, b, s, h_kv, d,
                                                        seed=40)
    seg = None
    if with_seg:
        seg = torch.zeros(b, s, dtype=torch.int32)
        seg[0, s // 3:], seg[0, s // 3 + 1:], seg[-1, s // 2:] = 1, 2, 3
        seg = seg.to(dev)
    out, lse = flash_attention.flash_attention(q, k, v, causal, seg, True)
    got = flash_attention.flash_attention_bwd(q, k, v, out, lse, do, causal,
                                              seg)
    ref = flash_attention.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                    causal, seg)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert torch.isfinite(a).all(), name
        if r.float().norm() == 0:
            # S = 1, causal: the one query sees only its own key, P = 1 and
            # dS = dP - delta = 0 exactly; the kernel's two f32 sums of the
            # same products (dO V^T and rowsum(dO * O)) may differ in the
            # last bits
            assert (a.float() - r.float()).abs().max().item() <= 1e-5, name
            continue
        assert _rel_l2(a, r) <= 1e-2, (name, _rel_l2(a, r))


def _flash_bwd_case(dev, b, s, h, h_kv, d, causal, seg, seed):
    q = _randn(dev, b, s, h, d, seed=seed)
    do = _randn(dev, b, s, h, d, seed=seed + 1)
    k = _randn(dev, b, s, h_kv, d, seed=seed + 2)
    v = _randn(dev, b, s, h_kv, d, seed=seed + 3)
    out, lse = flash_attention.flash_attention(q, k, v, causal, seg, True)
    return q, k, v, out, lse, do


@pytest.mark.parametrize("s", EDGE_S)
@pytest.mark.parametrize("rep", [1, 4, 8])
@pytest.mark.parametrize("mode", ["causal", "full", "segments"])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_bwd_kernel_tile_edges(dev, s, rep, mode, d):
    """S at the edges of the dq kernel's 128-query / 64-key tiles and the
    dk/dv kernel's 64-key / 32- or 64-query tiles, GQA 1, 4 and 8 (the
    group summed in the dk/dv block), causal, full and causal segments."""
    b, h_kv = 2, 1
    seg = None
    if mode == "segments":
        seg = flash_attention.segment_ids(
            s, [[c for c in (1, 63, 64, 65, s // 2) if 0 < c < s],
                [c for c in (s - 1,) if c > 0]]).to(dev)
    causal = mode != "full"
    ops = _flash_bwd_case(dev, b, s, h_kv * rep, h_kv, d, causal, seg, 70)
    got = flash_attention.flash_attention_bwd(*ops, causal, seg)
    ref = flash_attention.flash_attention_bwd_plain(*ops, causal, seg)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert torch.isfinite(a).all(), name
        if s == 1 and name != "dv":
            # one visible key: P = 1, so dS = dP - delta and dq, dk are 0
            # in exact arithmetic; both sides hold the rounding of two f32
            # sums of the same products (~1e-8), which a relative norm
            # cannot compare
            assert (a.float() - r.float()).abs().max().item() <= 1e-5, name
            continue
        assert _rel_l2(a, r) <= 1e-2, (name, _rel_l2(a, r))


@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_gpt2_train_shape(dev, d):
    """GPT-2 small's train shape, q [8, 1024, 12, 64] causal over 12 kv
    heads (and the same at D 128): the forward within one ulp, the
    backward within 1e-2 relative L2."""
    b, s, h = 8, 1024, 12
    ops = _flash_bwd_case(dev, b, s, h, h, d, True, None, 80)
    q, k, v, out, lse, do = ops
    ref_out, ref_lse = flash_attention.flash_attention_plain(q, k, v, True,
                                                             None, True)
    _close(out, ref_out)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)
    got = flash_attention.flash_attention_bwd(*ops, True, None)
    ref = flash_attention.flash_attention_bwd_plain(*ops, True, None)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert _rel_l2(a, r) <= 1e-2, (name, _rel_l2(a, r))


@pytest.mark.parametrize("b,s,h,h_kv,d,causal,with_seg", [
    (2, 1024, 32, 8, 128, True, False), (8, 1024, 12, 12, 64, True, False),
    (2, 300, 8, 2, 64, False, True)])
def test_flash_attention_bwd_is_deterministic(dev, b, s, h, h_kv, d, causal,
                                              with_seg):
    """Two backward calls on the same inputs return the same bits: no
    atomics, every output tile written by one block in a fixed order."""
    seg = flash_attention.segment_ids(s, [[s // 3], [s // 2]][:b] +
                                      [[]] * max(0, b - 2)).to(dev) \
        if with_seg else None
    ops = _flash_bwd_case(dev, b, s, h, h_kv, d, causal, seg, 90)
    first = flash_attention.flash_attention_bwd(*ops, causal, seg)
    second = flash_attention.flash_attention_bwd(*ops, causal, seg)
    torch.cuda.synchronize()
    for a, r in zip(first, second):
        assert torch.equal(a.view(torch.int16), r.view(torch.int16))
    fwd = [flash_attention.flash_attention(*ops[:3], causal, seg, True)
           for _ in range(2)]
    assert torch.equal(fwd[0][0].view(torch.int16), fwd[1][0].view(torch.int16))
    assert torch.equal(fwd[0][1], fwd[1][1])


# -- the Hopper building blocks (csrc/hopper.cuh), one tile each ---------------

@pytest.fixture(scope="module")
def hopper_check(tmp_path_factory):
    """tests/hopper_check.cu built with the kernels' flags against
    csrc/hopper.cuh."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import ctypes
    import os
    import subprocess
    from paddle_tpu_torch.ops.kernels import _build
    here = os.path.dirname(os.path.abspath(__file__))
    so = tmp_path_factory.mktemp("hopper") / "hopper_check.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC_DIR), "-o", str(so),
                    os.path.join(here, "hopper_check.cu")], check=True)
    lib = ctypes.CDLL(str(so))
    for name in ("ptt_check_ss", "ptt_check_rs", "ptt_check_mn_store",
                 "ptt_check_ss_t"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.ptt_check_tma_2d.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    lib.ptt_check_tma_2d.restype = ctypes.c_int
    lib.ptt_check_bulk.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    lib.ptt_check_bulk.restype = ctypes.c_int
    lib.ptt_check_s8.argtypes = [ctypes.c_void_p] * 4
    lib.ptt_check_s8.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("n", [24, 32, 48, 64, 128])
def test_hopper_wgmma_ss_kmajor(dev, hopper_check, n):
    """TMA with the 128-byte swizzle, an mbarrier, and the shared-memory
    wgmma chain with both operands K-major (eight 16-deep steps over two
    64-column sub-tiles): C = A B^T against torch.matmul in f32. N 24 and
    48 are the decode layer's Wgmma<24> / Wgmma<48> (three bf16 terms of
    its 8 or 16 batch columns)."""
    a, b = _randn(dev, 64, 128, seed=100), _randn(dev, n, 128, seed=101)
    c = torch.empty(64, n, device=dev)
    err = hopper_check.ptt_check_ss(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                    n, torch.cuda.current_stream().cuda_stream)
    assert err == 0
    ref = torch.matmul(a.float(), b.float().t())
    torch.testing.assert_close(c, ref, rtol=1e-5, atol=1e-4)


def test_hopper_wgmma_s8_kmajor(dev, hopper_check):
    """The int8 wgmma (WgmmaS8<256>, m64n256k32 s8.s8 -> s32) over two
    K-major 128-byte swizzled sub-tiles brought in by 2-D TMA boxes, each
    32-deep step 32 bytes further through desc_kmajor: C = A B^T exactly."""
    a = _int8(dev, 64, 256, seed=110, lo=-128)
    b = _int8(dev, 256, 256, seed=111, lo=-128)
    c = torch.empty(64, 256, dtype=torch.int32, device=dev)
    err = hopper_check.ptt_check_s8(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                    torch.cuda.current_stream().cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    ref = a.cpu().long() @ b.cpu().long().t()
    assert torch.equal(c.cpu().long(), ref)


@pytest.mark.parametrize("n", [64, 128])
def test_hopper_wgmma_rs_mnmajor(dev, hopper_check, n):
    """The register-A wgmma with B MN-major (N = 128 spans two sub-tiles,
    the descriptor's leading offset): A given as an f32 accumulator and
    packed to bf16 in registers, as the flash kernels form P."""
    a = torch.randn(64, 64, device=dev)
    b = _randn(dev, 64, n, seed=102)
    c = torch.empty(64, n, device=dev)
    err = hopper_check.ptt_check_rs(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                    n, torch.cuda.current_stream().cuda_stream)
    assert err == 0
    ref = torch.matmul(a.to(torch.bfloat16).float(), b.float())
    torch.testing.assert_close(c, ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n", [64, 128])
def test_hopper_wgmma_ss_mnmajor_a(dev, hopper_check, n):
    """The shared-memory wgmma with A MN-major (its transpose bit set) and
    B MN-major, as the weight-gradient kernel reads x^T and dy with the
    tokens as the reduction: C = A^T B for A [64 k, 64 m] and B [64 k, n]
    against torch.matmul in f32."""
    a, b = _randn(dev, 64, 64, seed=107), _randn(dev, 64, n, seed=108)
    c = torch.empty(64, n, device=dev)
    err = hopper_check.ptt_check_ss_t(a.data_ptr(), b.data_ptr(),
                                      c.data_ptr(), n,
                                      torch.cuda.current_stream().cuda_stream)
    assert err == 0
    ref = torch.matmul(a.float().t(), b.float())
    torch.testing.assert_close(c, ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n", [64, 128])
def test_hopper_proxy_fence_mn_store(dev, hopper_check, n):
    """Threads write four B tiles in turn into one MN-major swizzled tile
    (as the weight-only kernels write their dequantised weight), each
    followed by fence.proxy.async, a barrier and the wgmma that reads it:
    C = A (B_0 + .. + B_3) against torch.matmul in f32. A stale tile (a
    write the async proxy did not see) would show as a wrong sum."""
    a = _randn(dev, 64, 64, seed=103)
    b = _randn(dev, 4, 64, n, seed=104)
    c = torch.empty(64, n, device=dev)
    err = hopper_check.ptt_check_mn_store(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), n,
        torch.cuda.current_stream().cuda_stream)
    assert err == 0
    ref = sum(torch.matmul(a.float(), b[r].float()) for r in range(4))
    torch.testing.assert_close(c, ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("elem,rows,cols,box_rows,c0,r0", [
    (1, 300, 1056, 64, 128, 64),     # int8, inside
    (1, 300, 1056, 64, 1024, 256),   # int8, past the last row and column
    (1, 40, 48, 64, 0, 0),           # int8, a box larger than the tensor
    (4, 37, 1056, 9, 1024, 32),      # f32 scale rows, past both edges
    (4, 125, 2080, 1, 1920, 124)])   # f32, one row at the last one
def test_hopper_tma_2d_zero_fill(dev, hopper_check, elem, rows, cols,
                                 box_rows, c0, r0):
    """A 2-D tensor-map box (int8 with the 128-byte swizzle, as the
    weight-only kernels load the weight; f32 unswizzled, as they load the
    grouped scales), copied out with the swizzle undone: the tensor's
    elements inside it, zeros past its edges."""
    g = torch.Generator(device=dev).manual_seed(105)
    if elem == 1:
        src = torch.randint(-128, 128, (rows, cols), generator=g, device=dev,
                            dtype=torch.int8)
    else:
        src = torch.rand(rows, cols, generator=g, device=dev) + 0.5
    out = torch.full((box_rows, 128), 7, dtype=src.dtype, device=dev)
    err = hopper_check.ptt_check_tma_2d(
        src.data_ptr(), out.data_ptr(), rows, cols, elem, box_rows, c0, r0,
        torch.cuda.current_stream().cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    want = torch.zeros_like(out)
    part = src[r0:r0 + box_rows, c0:c0 + 128]
    want[:part.shape[0], :part.shape[1]] = part
    assert torch.equal(out, want)


@pytest.mark.parametrize("rows,bytes_,stride", [(8, 128, 8192), (16, 48, 2064),
                                               (5, 16, 28672)])
def test_hopper_bulk_copies(dev, hopper_check, rows, bytes_, stride):
    """Bulk copies without a tensor map (as the decode kernel brings x's
    rows into each stage, the last stage shorter), several on one
    mbarrier: the bytes arrive exactly."""
    g = torch.Generator(device=dev).manual_seed(106)
    src = torch.randint(-128, 128, (rows, stride), generator=g, device=dev,
                        dtype=torch.int8)
    out = torch.zeros(rows, bytes_, dtype=torch.int8, device=dev)
    err = hopper_check.ptt_check_bulk(src.data_ptr(), out.data_ptr(), rows,
                                      bytes_, stride,
                                      torch.cuda.current_stream().cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    assert torch.equal(out, src[:, :bytes_])


@pytest.mark.parametrize("n", [4096, 1000003])
@pytest.mark.parametrize("form", ["master", "f32", "bf16", "f32_grad"])
def test_adamw_kernel_is_bit_exact(dev, n, form):
    """Three steps with an lr change and an lr factor; the kernel and the
    plain version on copies of the same state give the same bits."""
    gen = torch.Generator(device=dev).manual_seed(41)
    w0 = torch.randn(n, generator=gen, device=dev)
    master = w0.clone() if form == "master" else None
    param = w0.clone() if form in ("f32", "f32_grad") else \
        w0.to(torch.bfloat16)
    state = [param, torch.zeros(n, device=dev), torch.zeros(n, device=dev),
             master]
    ref = [None if t is None else t.clone() for t in state]
    kw = dict(beta1=0.9, beta2=0.95, eps=1e-8, wd=0.1)
    for step, (lr, mult) in enumerate(((1e-3, 1.0), (3e-4, 0.5),
                                       (2e-3, 1.0)), start=1):
        g = torch.randn(n, generator=gen, device=dev)
        if form != "f32_grad":
            g = g.to(torch.bfloat16)
        scal = adamw.adamw_scalars(torch.tensor(lr, device=dev),
                                   torch.tensor(float(step), device=dev),
                                   0.9, 0.95)
        adamw.adamw_update(state[0], g, state[1], state[2], scal,
                           master=state[3], lr_mult=mult, **kw)
        adamw.adamw_update_plain(ref[0], g, ref[1], ref[2], scal,
                                 master=ref[3], lr_mult=mult, **kw)
    torch.cuda.synchronize()
    for a, r in zip(state, ref):
        if a is not None:
            assert torch.equal(a, r)


def test_training_kernels_reject_what_they_do_not_take(dev):
    x = torch.zeros(2, 64, device=dev)                    # f32 on the card
    with pytest.raises(TypeError):
        rms_norm.rms_norm_bwd(x, torch.ones(64, device=dev), x)
    wide = torch.zeros(2, 16384, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                       # hidden > 8192
        rms_norm.rms_norm_bwd(wide, wide[0], wide)
    with pytest.raises(TypeError):
        swiglu.swiglu_bwd(x, x, x)
    q = torch.zeros(1, 8, 2, 64, device=dev)
    with pytest.raises(TypeError):
        flash_attention.flash_attention_bwd(
            q, q, q, q, torch.zeros(2, 8, device=dev), q)
    p = torch.zeros(8, device=dev, dtype=torch.float16)
    scal = torch.zeros(4, device=dev)
    with pytest.raises(TypeError):
        adamw.adamw_update(p, p, torch.zeros(8, device=dev),
                           torch.zeros(8, device=dev), scal, beta1=0.9,
                           beta2=0.99, eps=1e-8, wd=0.0)


def test_llama_training_step_through_kernels(dev):
    """A 2-layer llama_tiny-shaped bf16 model with ``fused_blocks=False``:
    one forward, backward and multi-precision AdamW step launches each
    training kernel the expected number of times, and its gradients agree
    with the plain path's."""
    layers = 2
    model = llama_tiny(device=dev, dtype=torch.bfloat16, hidden_size=256,
                       num_heads=4, num_kv_heads=2, intermediate_size=512)
    model.fused_blocks = False
    gen = torch.Generator(device=dev).manual_seed(42)
    ids = torch.randint(0, 512, (2, 100), generator=gen, device=dev)
    labels = torch.randint(0, 512, (2, 100), generator=gen, device=dev)
    _, loss_p = model(ids, labels=labels, plain=True)
    loss_p.backward()
    ref = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    opt = AdamW(1e-4, parameters=model.parameters(), multi_precision=True,
                grad_clip=ClipGradByGlobalNorm(1.0))
    for w in WRAPPERS.values():
        w.launches = 0
    _, loss = model(ids, labels=labels)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    opt.step()
    opt.clear_grad()
    torch.cuda.synchronize()
    n_params = len(list(model.parameters()))
    want = {"rms_norm": 2 * layers + 1, "rms_norm_bwd": 2 * layers + 1,
            "rope": 4 * layers, "swiglu": layers, "swiglu_bwd": layers,
            "flash_attention": layers, "flash_attention_bwd": layers,
            "adamw": n_params}
    got = {n: w.launches for n, w in WRAPPERS.items() if w.launches}
    assert got == want
    assert n_params == 9 * layers + 3
    assert abs(loss.item() - loss_p.item()) <= 5e-3 * abs(loss_p.item())
    for name, g in grads.items():
        assert _rel_l2(g, ref[name]) <= 2e-2, name


def _sum_close(got, ref):
    """An f32 sum over rows taken in another order: 1e-3 of its largest
    value."""
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 1e-3 * ref.float().abs().max().item(), err


@pytest.mark.parametrize("act,norm,p,bias_on", EPI_CASES)
@pytest.mark.parametrize("rows,hidden,with_gh", [(1, 64, True),
                                                 (37, 4096, True),
                                                 (1000, 768, False),
                                                 (5, 12288, True)])
def test_block_epilogue_bwd_kernel(dev, act, norm, p, bias_on, rows, hidden,
                                   with_gh):
    xw = 2 * hidden if act == "swiglu" else hidden
    x = _randn(dev, rows, xw, seed=50) if act else None
    h = _randn(dev, rows, hidden, seed=51)
    w = _randn(dev, hidden, seed=52)
    gy = _randn(dev, rows, hidden, seed=53)
    gh = _randn(dev, rows, hidden, seed=54) if with_gh else None
    args = (h, x, w, gy, gh, 1234, p, 1e-5, act, norm, bias_on)
    got = block_epilogue.fused_epilogue_bwd(*args)
    ref = block_epilogue.fused_epilogue_bwd_plain(*args)
    _close(got[0], ref[0])
    _close(got[1], ref[1])
    _sum_close(got[2], ref[2])
    if bias_on:
        _sum_close(got[3], ref[3])
    else:
        assert got[3] is None
    # repeatable: no atomics, the same sums every run
    again = block_epilogue.fused_epilogue_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again)
               if a is not None)
    if p:
        # a zero gy leaves dres = gh, and dx zero exactly where the forward
        # dropped (gh bounded away from 0)
        gh1 = (_randn(dev, rows, hidden, seed=55).float().abs() + 1.0).to(
            torch.bfloat16)
        dx0 = block_epilogue.fused_epilogue_bwd(
            h, None, w, torch.zeros_like(gy), gh1, 1234, p, 1e-5, None,
            norm, bias_on)[0]
        keep = block_epilogue.keep_mask(rows, hidden, 1234, p, dev)
        assert torch.equal(dx0 != 0, keep)


@pytest.mark.parametrize("act,norm,p,bias_on", EPI_CASES)
@pytest.mark.parametrize("rows", [1, 37, 8192])
@pytest.mark.parametrize("hidden", [768, 776, 4096, 8192, 12288])
def test_block_epilogue_bwd_kernel_widths(dev, act, norm, p, bias_on, rows,
                                          hidden):
    """A warp a row (768, 776), groups of 4 and 8 warps (4096, 8192), a
    wide group of 6 warps summing in shared memory (12288), at one row, an
    odd count and a whole strip a group; dx and dres within one bf16 ulp,
    dw and db within 1e-3 of their largest values."""
    xw = 2 * hidden if act == "swiglu" else hidden
    x = _randn(dev, rows, xw, seed=60) if act else None
    h = _randn(dev, rows, hidden, seed=61)
    w = _randn(dev, hidden, seed=62)
    gy = _randn(dev, rows, hidden, seed=63)
    gh = _randn(dev, rows, hidden, seed=64)
    args = (h, x, w, gy, gh, 1234, p, 1e-5, act, norm, bias_on)
    got = block_epilogue.fused_epilogue_bwd(*args)
    ref = block_epilogue.fused_epilogue_bwd_plain(*args)
    _close(got[0], ref[0])
    _close(got[1], ref[1])
    _sum_close(got[2], ref[2])
    if bias_on:
        _sum_close(got[3], ref[3])


@pytest.mark.parametrize("rows,hidden,act,norm,p,bias_on", [
    (3, 19280, None, "rms", 0.0, False), (3, 19280, "swiglu", "layer", 0.1,
                                          False),
    (3, 14464, "gelu", "layer", 0.2, True)])
def test_block_epilogue_bwd_kernel_at_the_contract_limit(dev, rows, hidden, act,
                                                         norm, p, bias_on):
    """The widest rows the wrapper takes ((3 + bias) * hidden f32 within
    227 KB less 1 KB): a wide group of 10 or 8 warps."""
    xw = 2 * hidden if act == "swiglu" else hidden
    x = _randn(dev, rows, xw, seed=70) if act else None
    h, gy, gh = (_randn(dev, rows, hidden, seed=s) for s in (71, 72, 73))
    w = _randn(dev, hidden, seed=74)
    args = (h, x, w, gy, gh, 1234, p, 1e-5, act, norm, bias_on)
    got = block_epilogue.fused_epilogue_bwd(*args)
    ref = block_epilogue.fused_epilogue_bwd_plain(*args)
    _close(got[0], ref[0])
    _close(got[1], ref[1])
    _sum_close(got[2], ref[2])
    if bias_on:
        _sum_close(got[3], ref[3])


@pytest.mark.parametrize("rows,hidden,act,norm,p,bias_on", [
    (8192, 768, None, "layer", 0.0, True), (4096, 4096, None, "rms", 0.0,
                                            False),
    (4096, 4096, "swiglu", "rms", 0.4, False), (37, 12288, "gelu", "layer",
                                                0.2, True)])
def test_block_epilogue_bwd_is_deterministic(dev, rows, hidden, act, norm, p,
                                             bias_on):
    """No atomics: the partial rows are added in a fixed order, so three
    calls give the same bits."""
    xw = 2 * hidden if act == "swiglu" else hidden
    x = _randn(dev, rows, xw, seed=65) if act else None
    h, gy, gh = (_randn(dev, rows, hidden, seed=s) for s in (66, 67, 68))
    w = _randn(dev, hidden, seed=69)
    args = (h, x, w, gy, gh, 1234, p, 1e-5, act, norm, bias_on)
    runs = [block_epilogue.fused_epilogue_bwd(*args) for _ in range(3)]
    torch.cuda.synchronize()
    for other in runs[1:]:
        assert all(torch.equal(a.view(torch.int16) if a.dtype ==
                               torch.bfloat16 else a, b.view(torch.int16)
                               if b.dtype == torch.bfloat16 else b)
                   for a, b in zip(runs[0], other) if a is not None)


@pytest.mark.parametrize("shape", [(3, 2 * 64), (4096, 2 * 14336),
                                   (2, 5, 2 * 8)])
def test_swiglu_packed_kernels(dev, shape):
    x = _randn(dev, *shape, seed=56)
    dy = _randn(dev, *shape[:-1], shape[-1] // 2, seed=57)
    _close(swiglu.swiglu_packed(x), swiglu.swiglu_packed_plain(x))
    _close(swiglu.swiglu_packed_bwd(x, dy),
           swiglu.swiglu_packed_bwd_plain(x, dy))


def test_new_training_kernels_reject_what_they_do_not_take(dev):
    x = torch.zeros(2, 64, device=dev)                    # f32 on the card
    with pytest.raises(TypeError):
        block_epilogue.fused_epilogue_bwd(x, None, torch.ones(64, device=dev),
                                          x)
    wide = torch.zeros(2, 16384, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                       # shared memory
        block_epilogue.fused_epilogue_bwd(wide, None, wide[0], wide,
                                          norm="layer", has_bias=True)
    with pytest.raises(TypeError):
        swiglu.swiglu_packed(x)
    odd = torch.zeros(2, 2 * 12, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                       # I % 8 != 0
        swiglu.swiglu_packed(odd)


def _fused_step_launches(model, ids, labels):
    """Gradients of the plain path, then one kernel step's launches and
    gradients (multi-precision AdamW, global-norm clip)."""
    _, loss_p = model(ids, labels=labels, plain=True)
    loss_p.backward()
    ref = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    opt = AdamW(1e-4, parameters=model.parameters(), multi_precision=True,
                grad_clip=ClipGradByGlobalNorm(1.0))
    for w in WRAPPERS.values():
        w.launches = 0
    _, loss = model(ids, labels=labels)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    opt.step()
    opt.clear_grad()
    torch.cuda.synchronize()
    got = {n: w.launches for n, w in WRAPPERS.items() if w.launches}
    assert abs(loss.item() - loss_p.item()) <= 5e-3 * abs(loss_p.item())
    for name, g in grads.items():
        assert _rel_l2(g, ref[name]) <= 5e-2, name
    return got


def test_llama_fused_trunk_training_step_through_kernels(dev):
    """The default fused trunk: one step launches the block epilogue and
    its backward at both junctions of every layer."""
    layers = 2
    model = llama_tiny(device=dev, dtype=torch.bfloat16, hidden_size=256,
                       num_heads=4, num_kv_heads=2, intermediate_size=512)
    assert model.fused_blocks
    gen = torch.Generator(device=dev).manual_seed(43)
    ids = torch.randint(0, 512, (2, 100), generator=gen, device=dev)
    labels = torch.randint(0, 512, (2, 100), generator=gen, device=dev)
    got = _fused_step_launches(model, ids, labels)
    assert got == {"rms_norm": 1, "rms_norm_bwd": 1,
                   "block_epilogue": 2 * layers,
                   "block_epilogue_bwd": 2 * layers, "rope": 4 * layers,
                   "swiglu": layers, "swiglu_bwd": layers,
                   "flash_attention": layers,
                   "flash_attention_bwd": layers,
                   "adamw": 9 * layers + 3}


def test_gpt_training_step_through_kernels(dev):
    """A 2-layer GPT at head dim 64 on the fused trunk: the block
    epilogue (layer norm with its bias) forward and backward at every
    junction, flash attention forward and backward, AdamW; nothing
    else."""
    layers = 2
    model = gpt2_tiny(device=dev, dtype=torch.bfloat16, hidden_size=256,
                      num_heads=4)
    gen = torch.Generator(device=dev).manual_seed(44)
    ids = torch.randint(0, 1024, (2, 100), generator=gen, device=dev)
    labels = torch.randint(0, 1024, (2, 100), generator=gen, device=dev)
    got = _fused_step_launches(model, ids, labels)
    assert got == {"block_epilogue": 2 * layers,
                   "block_epilogue_bwd": 2 * layers,
                   "flash_attention": layers,
                   "flash_attention_bwd": layers,
                   "adamw": 12 * layers + 4}


@pytest.mark.parametrize("n", [7, 768, 1000, 21000, 1000003])
@pytest.mark.parametrize("form", ["master", "f32", "bf16", "f32_grad"])
def test_lamb_kernel(dev, n, form):
    """Three steps with an lr change, an lr factor and weight decay from
    the same state: the moments bit for bit, the trust ratio and the
    weights to 1e-6 relative, a bf16 parameter to one ulp."""
    gen = torch.Generator(device=dev).manual_seed(43)
    w0 = torch.randn(n, generator=gen, device=dev) * 0.1
    master = w0.clone() if form == "master" else None
    param = w0.clone() if form in ("f32", "f32_grad") else \
        w0.to(torch.bfloat16)
    state = [param, torch.zeros(n, device=dev), torch.zeros(n, device=dev),
             master]
    ref = [None if t is None else t.clone() for t in state]
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-6, wd=0.01)
    for step, (lr, mult) in enumerate(((1e-3, 1.0), (3e-4, 0.5),
                                       (2e-3, 1.0)), start=1):
        g = torch.randn(n, generator=gen, device=dev) * 1e-2
        if form != "f32_grad":
            g = g.to(torch.bfloat16)
        scal = adamw.adamw_scalars(torch.tensor(lr, device=dev),
                                   torch.tensor(float(step), device=dev),
                                   0.9, 0.999)
        trust = lamb.lamb_update(state[0], g, state[1], state[2], scal,
                                 master=state[3], lr_mult=mult, **kw)
        want = lamb.lamb_update_plain(ref[0], g, ref[1], ref[2], scal,
                                      master=ref[3], lr_mult=mult, **kw)
        torch.cuda.synchronize()
        assert abs(trust.item() - want.item()) <= 1e-6 * want.item()
        assert torch.equal(state[1], ref[1]) and torch.equal(state[2], ref[2])
        for a, r in ((state[0], ref[0]), (state[3], ref[3])):
            if a is None:
                continue
            err = (a.float() - r.float()).abs().max().item()
            rel = 2.0 ** -7 if a.dtype == torch.bfloat16 else 1e-6
            assert err <= rel * r.float().abs().max().item(), (step, err)
        # resynchronise the two so the next step starts from one state
        for a, r in zip(state, ref):
            if a is not None:
                r.copy_(a)


def test_lamb_kernel_is_deterministic_and_counts(dev):
    """Two calls from the same state give the same bits (the partial sums
    are combined in a fixed order), and each call counts one launch."""
    n = 3 * 1056 * 1024 + 5
    gen = torch.Generator(device=dev).manual_seed(5)
    w = torch.randn(n, generator=gen, device=dev)
    g = torch.randn(n, generator=gen, device=dev).to(torch.bfloat16)
    scal = adamw.adamw_scalars(torch.tensor(1e-3, device=dev),
                               torch.tensor(2.0, device=dev), 0.9, 0.999)
    outs = []
    lamb.lamb_update.launches = 0
    for _ in range(2):
        state = [w.clone(), torch.full_like(w, 1e-3), torch.full_like(w, 1e-6)]
        trust = lamb.lamb_update(state[0], g, state[1], state[2], scal,
                                 beta1=0.9, beta2=0.999, eps=1e-6, wd=0.01)
        outs.append(state + [trust])
    torch.cuda.synchronize()
    assert lamb.lamb_update.launches == 2
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.parametrize("n,v,dtype,vocab_start", [
    (5, 1000, torch.float32, 0), (3, 1001, torch.bfloat16, 0),
    (7, 1001, torch.float32, 500), (64, 50304, torch.bfloat16, 0),
    (2, 128256, torch.bfloat16, 0), (33, 4096, torch.bfloat16, 1024)])
def test_parallel_ce_kernel(dev, n, v, dtype, vocab_start):
    gen = torch.Generator(device=dev).manual_seed(n + v)
    x = (torch.randn(n, v, generator=gen, device=dev) * 4).to(dtype)
    lab = torch.randint(0, vocab_start + v + 50, (n,), generator=gen,
                        device=dev)
    lab[0] = vocab_start + v + 3                  # outside the shard
    got = parallel_ce.row_stats(x, lab, vocab_start)
    ref = parallel_ce.row_stats_plain(x, lab, vocab_start)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[2], ref[2])
    assert ((got[1] - ref[1]).abs() <= 1e-5 * ref[1]).all()
    assert got[2][0].item() == torch.tensor(-1e30).item()


def test_parallel_cross_entropy_backward_on_the_card(dev):
    """``ParallelCrossEntropy`` on bf16 logits: one kernel launch in the
    forward, the loss and the bf16 gradient against the plain path."""
    gen = torch.Generator(device=dev).manual_seed(3)
    x = (torch.randn(4, 9, 50304, generator=gen, device=dev) * 2).to(
        torch.bfloat16)
    lab = torch.randint(0, 50304, (4, 9), generator=gen, device=dev)
    lab[1, 2] = -100
    out = []
    for plain in (True, False):
        xl = x.clone().requires_grad_()
        parallel_ce.row_stats.launches = 0
        loss = ParallelCrossEntropy()(xl, lab, plain=plain)
        loss.mean().backward()
        out.append((loss.detach(), xl.grad))
        assert parallel_ce.row_stats.launches == (0 if plain else 1)
    torch.cuda.synchronize()
    (lp, gp), (lk, gk) = out
    assert (lk - lp).abs().max().item() <= 1e-5
    _close(gk, gp)
    assert not gk[1, 2].any()


def test_lamb_and_ce_reject_what_they_do_not_take(dev):
    p = torch.zeros(8, device=dev, dtype=torch.float16)
    scal = torch.zeros(4, device=dev)
    with pytest.raises(TypeError):
        lamb.lamb_update(p, p, torch.zeros(8, device=dev),
                         torch.zeros(8, device=dev), scal, beta1=0.9,
                         beta2=0.99, eps=1e-6, wd=0.0)
    w = torch.zeros(16, device=dev)
    with pytest.raises(ValueError):                      # not contiguous
        lamb.lamb_update(w[::2], w[::2], w[::2], w[::2], scal, beta1=0.9,
                         beta2=0.99, eps=1e-6, wd=0.0)
    x = torch.zeros(4, 100, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        parallel_ce.row_stats(x, torch.zeros(4, dtype=torch.int64,
                                             device=dev))
    y = torch.zeros(4, 100, device=dev)
    with pytest.raises(ValueError):
        parallel_ce.row_stats(y.t(), torch.zeros(100, dtype=torch.int64,
                                                 device=dev))


def _sync_free_step(opt, params, gen):
    """One backward and an ``opt.step()`` that must not synchronise."""
    loss = sum((p.float() * torch.randn(p.shape, generator=gen,
                                        device=p.device)).sum()
               for p in params)
    loss.backward()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        opt.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    opt.clear_grad()


@pytest.mark.parametrize("name,kw", [
    ("SGD", dict(weight_decay=regularizer.L2Decay(0.01),
                 grad_clip=clip.ClipGradByValue(0.5))),
    ("Momentum", dict(use_nesterov=True,
                      grad_clip=clip.ClipGradByNorm(1.0))),
    ("Adagrad", {}), ("Adadelta", {}), ("Adamax", {}),
    ("RMSProp", dict(centered=True, momentum=0.9)),
    ("Adam", dict(weight_decay=regularizer.L1Decay(1e-4))),
    ("AdamW", dict(grad_clip=clip.ClipGradByGlobalNorm(1.0))),
    ("Lamb", dict(multi_precision=True,
                  grad_clip=clip.ClipGradByGlobalNorm(1.0)))])
def test_optimizer_step_does_not_synchronise(dev, name, kw):
    """Each optimizer's step on the card, with a scheduler bound: no host
    synchronisation, and a scheduler step neither."""
    gen = torch.Generator(device=dev).manual_seed(9)
    dtype = torch.bfloat16 if kw.get("multi_precision") else torch.float32
    params = [torch.nn.Parameter(torch.randn(s, generator=gen, device=dev)
                                 .to(dtype)) for s in ((64, 48), (48,))]
    sched = optimizer.lr.LinearWarmup(
        optimizer.lr.CosineAnnealingDecay(1e-2, T_max=4), warmup_steps=1,
        start_lr=0.0, end_lr=1e-2)
    opt = getattr(optimizer, name)(learning_rate=sched, parameters=params,
                                   **kw)
    for _ in range(2):
        _sync_free_step(opt, params, gen)
        torch.cuda.set_sync_debug_mode("error")
        try:
            sched.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert all(torch.isfinite(p.float()).all() for p in params)


def test_gpt_lamb_step_through_kernels(dev):
    """A 2-layer GPT in bf16 with chip_smoke's train_lamb recipe: one step
    launches lamb once per parameter and parallel_ce once, beside the
    trunk's kernels."""
    layers = 2
    model = gpt2_tiny(device=dev, dtype=torch.bfloat16, hidden_size=256,
                      num_heads=4)
    sched = optimizer.lr.LinearWarmup(
        optimizer.lr.CosineAnnealingDecay(2e-3, T_max=8), warmup_steps=2,
        start_lr=0.0, end_lr=2e-3)
    opt = optimizer.Lamb(learning_rate=sched, lamb_weight_decay=0.01,
                         exclude_from_weight_decay_fn=lambda p: p.ndim == 1,
                         multi_precision=True,
                         parameters=model.parameters(),
                         grad_clip=ClipGradByGlobalNorm(1.0))
    gen = torch.Generator(device=dev).manual_seed(45)
    ids = torch.randint(0, 1024, (2, 100), generator=gen, device=dev)
    labels = torch.randint(0, 1024, (2, 100), generator=gen, device=dev)
    ce = ParallelCrossEntropy()
    for _ in range(2):
        torch.cuda.synchronize()
        for w in WRAPPERS.values():
            w.launches = 0
        loss = ce(model(ids), labels).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        torch.cuda.synchronize()
    got = {n: w.launches for n, w in WRAPPERS.items() if w.launches}
    assert got == {"block_epilogue": 2 * layers,
                   "block_epilogue_bwd": 2 * layers,
                   "flash_attention": layers,
                   "flash_attention_bwd": layers,
                   "lamb": 12 * layers + 4, "parallel_ce": 1}
    assert torch.isfinite(loss).item()


# -- the grouped expert product (MoE) ---------------------------------------------

def _grouped_operands(dev, e, c, h, f, transposed, seed):
    """x with non-zero padding rows, w as [E, H, F] or as the transposed
    view of an [E, F, H] tensor, and counts holding 0, c and partial
    fills."""
    x = _randn(dev, e, c, h, seed=seed)
    if transposed:
        w = (_randn(dev, e, f, h, seed=seed + 1) * 0.05).transpose(1, 2)
    else:
        w = _randn(dev, e, h, f, seed=seed + 1) * 0.05
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    counts = torch.randint(0, c + 1, (e,), generator=g, device=dev,
                           dtype=torch.int32)
    counts[0], counts[-1] = 0, c
    return x, w, counts


@pytest.mark.parametrize("transposed", [False, True], ids=["ehf", "efh^T"])
@pytest.mark.parametrize("e,c,h,f", [(4, 10, 256, 384), (3, 274, 2048, 1408),
                                     (3, 274, 1408, 2048), (2, 65, 24, 40),
                                     (2, 1, 16, 8)])
def test_grouped_matmul_kernel(dev, e, c, h, f, transposed):
    x, w, counts = _grouped_operands(dev, e, c, h, f, transposed, seed=c + f)
    before = WRAPPERS["moe_gemm"].launches
    got = moe_gemm.grouped_matmul(x, w, counts)
    assert WRAPPERS["moe_gemm"].launches == before + 1
    ref = moe_gemm.grouped_matmul_plain(x, w, counts)
    _close(got, ref)
    live = moe_gemm.live_rows(counts, c)
    assert not got.masked_select(~live).any()     # padding never leaks


@pytest.mark.parametrize("transposed", [False, True], ids=["ehf", "efh^T"])
@pytest.mark.parametrize("e,c,h,f", [(3, 37, 72, 136), (3, 547, 2048, 1408),
                                     (3, 547, 1408, 2048), (5, 200, 64, 64)])
def test_grouped_matmul_capacities(dev, e, c, h, f, transposed):
    """The capacities the paths run (37 and the tails of one box in K and
    N; 547, train_moe's, five 128-row groups with the last one short) and
    a one-box K and N, with an empty and a full expert: within one bf16
    ulp of the plain version, exact zeros past the counts."""
    x, w, counts = _grouped_operands(dev, e, c, h, f, transposed, seed=c + h)
    got = moe_gemm.grouped_matmul(x, w, counts)
    ref = moe_gemm.grouped_matmul_plain(x, w, counts)
    _close(got, ref)
    live = moe_gemm.live_rows(counts, c)
    assert not got.masked_select(~live).any()


@pytest.mark.parametrize("transposed", [False, True], ids=["ehf", "efh^T"])
def test_grouped_matmul_deterministic(dev, transposed):
    """Two calls on the same inputs give the same bits (C 547)."""
    x, w, counts = _grouped_operands(dev, 4, 547, 2048, 1408, transposed,
                                     seed=9)
    a = moe_gemm.grouped_matmul(x, w, counts)
    b = moe_gemm.grouped_matmul(x, w, counts)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_grouped_matmul_takes_bf16_only(dev):
    x, w, counts = _grouped_operands(dev, 2, 8, 16, 16, False, seed=3)
    with pytest.raises(TypeError, match="bf16"):
        moe_gemm.grouped_matmul(x.float(), w.float(), counts)
    with pytest.raises(ValueError, match="% 8"):
        moe_gemm.grouped_matmul(x[..., :12], w[:, :12], counts)


def test_moe_layer_forward_and_backward_on_the_card(dev):
    """One MoELayer (8 experts of 256, top-2, a shared expert, capacity
    factor 0.5) forward and backward through the kernels against the plain
    path from the same weights: the routing is identical (the gate is one
    product on both paths), the output and every gradient within 2e-2
    relative L2 (bf16 roundings of the products and the SwiGLU gate), and
    three grouped launches each way."""
    torch.manual_seed(0)
    experts = [_SwiGLU(512, 256, 0.05, 2) for _ in range(8)]
    layer = MoELayer(512, experts, gate={"type": "gshard", "top_k": 2},
                     capacity_factor=0.5,
                     shared_experts=_SwiGLU(512, 512, 0.05, 2)).to(
        dev, torch.bfloat16)
    x = _randn(dev, 4, 64, 512, seed=4).requires_grad_()
    cot = _randn(dev, 4, 64, 512, seed=5)

    def run(plain):
        out = layer(x, plain=plain)
        (out.float() * cot.float()).sum().add(layer.l_aux).backward()
        grads = [x.grad] + [p.grad for p in layer.parameters()]
        res = [out.detach()] + [g.clone() for g in grads]
        x.grad = None
        layer.zero_grad(set_to_none=True)
        return res, layer.l_aux.item()

    ref, aux_p = run(True)
    WRAPPERS["moe_gemm"].launches = 0
    got, aux_k = run(False)
    assert WRAPPERS["moe_gemm"].launches == 6
    assert aux_k == aux_p
    for a, r in zip(got, ref):
        err = ((a.float() - r.float()).norm() / r.float().norm()).item()
        assert err <= 2e-2, err


# -- the incubate fused ops: masked softmax, bias-dropout-residual layer
# norm, dropout-add, the weight-gradient accumulation ------------------------

def _rand(dev, *shape, seed=0, dtype=torch.bfloat16):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("x_shape,mask_shape", [
    ((2, 3, 5, 16), (2, 1, 5, 16)), ((2, 3, 5, 16), (1, 1, 5, 16)),
    ((2, 3, 5, 16), (2, 1, 1, 16)), ((2, 3, 5, 16), (16,)),
    ((2, 3, 5, 16), (2, 3, 5, 16)), ((8, 12, 64, 1024), (8, 1, 64, 1024)),
    ((1, 2, 3, 2048), (1, 1, 3, 1))])
def test_softmax_mask_kernel(dev, dtype, x_shape, mask_shape):
    x = _rand(dev, *x_shape, seed=60, dtype=dtype) * 4
    mask = _rand(dev, *mask_shape, seed=61, dtype=dtype) * 3
    before = WRAPPERS["softmax_mask"].launches
    got = softmax_mask.softmax_mask(x, mask)
    assert WRAPPERS["softmax_mask"].launches == before + 1
    _close(got, softmax_mask.softmax_mask_plain(x, mask))
    dy = _rand(dev, *x_shape, seed=62, dtype=dtype)
    _close(softmax_mask.softmax_mask_bwd(got, dy),
           softmax_mask.softmax_mask_bwd_plain(got, dy))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 3, 8, 8), (2, 3, 5, 24),
                                   (1, 2, 24, 8), (2, 12, 1024, 1024)])
def test_softmax_mask_tri_kernel(dev, dtype, shape):
    x = _rand(dev, *shape, seed=63, dtype=dtype) * 4
    got = softmax_mask.softmax_mask_tri(x)
    ref = softmax_mask.softmax_mask_tri_plain(x)
    _close(got, ref)
    sq, sk = shape[-2:]
    above = (torch.arange(sk, device=dev)[None, :]
             > torch.arange(sq, device=dev)[:, None])
    assert not got[..., above].any()              # the top-left triangle


def test_softmax_mask_fully_masked_row_is_nan_on_both(dev):
    x = _rand(dev, 1, 2, 3, 16, seed=64)
    mask = torch.zeros(1, 1, 3, 16, device=dev)
    mask[0, 0, 1] = float("-inf")
    got = softmax_mask.softmax_mask(x, mask)
    ref = softmax_mask.softmax_mask_plain(x, mask)
    assert torch.isnan(got[:, :, 1]).all() and torch.isnan(ref[:, :, 1]).all()
    _close(got[:, :, 0], ref[:, :, 0])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_mask", [True, False])
@pytest.mark.parametrize("rows,hidden", [(1, 64), (51, 768), (8192, 768),
                                         (300, 4096), (7, 8192)])
def test_bias_dropout_ln_kernels(dev, dtype, with_mask, rows, hidden):
    x = _rand(dev, rows, hidden, seed=70, dtype=dtype)
    res = _rand(dev, rows, hidden, seed=71, dtype=dtype)
    bias = _rand(dev, hidden, seed=72, dtype=dtype) * 0.1
    gamma = 1.0 + _rand(dev, hidden, seed=73, dtype=dtype) * 0.1
    beta = _rand(dev, hidden, seed=74, dtype=dtype) * 0.1
    mask = None
    if with_mask:
        g = torch.Generator(device=dev).manual_seed(75)
        mask = (torch.rand(rows, hidden, generator=g, device=dev) >= 0.1
                ).float() / 0.9
    args = (x, bias, res, mask, gamma, beta, 1e-5)
    before = WRAPPERS["bias_dropout_ln"].launches
    got = bias_dropout_ln.bias_dropout_ln(*args)
    assert WRAPPERS["bias_dropout_ln"].launches == before + 1
    ref = bias_dropout_ln.bias_dropout_ln_plain(*args)
    _close(got[0], ref[0])
    _close(got[1], ref[1])
    dy = _rand(dev, rows, hidden, seed=76, dtype=dtype)
    bargs = (ref[1], mask, gamma, dy, 1e-5)
    got = bias_dropout_ln.bias_dropout_ln_bwd(*bargs)
    ref = bias_dropout_ln.bias_dropout_ln_bwd_plain(*bargs)
    _close(got[0], ref[0])
    _close(got[1], ref[1])
    for a, r in zip(got[2:], ref[2:]):
        _sum_close(a, r)
    again = bias_dropout_ln.bias_dropout_ln_bwd(*bargs)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_bias_dropout_ln_rejects_what_it_does_not_take(dev):
    x = torch.zeros(2, 8200, device=dev, dtype=torch.bfloat16)
    v = torch.zeros(8200, device=dev)
    with pytest.raises(ValueError, match="hidden"):
        bias_dropout_ln.bias_dropout_ln(x, v, x, None, v, v, 1e-5)
    h = torch.zeros(2, 64, device=dev, dtype=torch.float16)
    w = torch.zeros(64, device=dev)
    with pytest.raises(TypeError):
        bias_dropout_ln.bias_dropout_ln(h, w, h, None, w, w, 1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,p", [((8192, 768), 0.1), ((3, 7, 11), 0.5),
                                     ((5,), 0.3), ((4096, 4096), 0.1)])
def test_dropout_add_kernels(dev, dtype, shape, p):
    x = _rand(dev, *shape, seed=80, dtype=dtype)
    res = _rand(dev, *shape, seed=81, dtype=dtype)
    before = (WRAPPERS["dropout_add"].launches,
              WRAPPERS["dropout_add_bwd"].launches)
    got = dropout_add.dropout_add(x, res, 12345, p)
    assert torch.equal(got, dropout_add.dropout_add_plain(x, res, 12345, p))
    dx = dropout_add.dropout_add_bwd(x, 12345, p)
    assert torch.equal(dx, dropout_add.dropout_add_bwd_plain(x, 12345, p))
    assert (WRAPPERS["dropout_add"].launches,
            WRAPPERS["dropout_add_bwd"].launches) == \
        (before[0] + 1, before[1] + 1)
    ones = torch.ones(shape, device=dev, dtype=dtype)
    keep = dropout_add.keep_mask(1, x.numel(), 12345, p, dev).reshape(shape)
    assert torch.equal(dropout_add.dropout_add_bwd(ones, 12345, p) != 0, keep)


# (M, K, N): the incubate path's four products, phase 3's, tails past
# every tile (M past 64 tokens, K past 256, N past 128) at splits 1, 2 and
# 8, and M = 0; together every split of the plan (the out product takes 4)
_GRAD_SHAPES = [(1000, 64, 72), (8192, 768, 3072), (33, 136, 8), (1, 8, 264),
                (4096, 256, 1024), (4096, 768, 2304), (4096, 768, 768),
                (4096, 768, 3072), (4096, 3072, 768), (4096, 4096, 14336),
                (37, 136, 264), (1000, 1800, 1000), (2085, 264, 200),
                (0, 136, 264)]


def _grad_close(got, want):
    """Within 1e-4 of the largest reference value (f32 acc: the same f32
    sums in another order), or one bf16 ulp of it (bf16 acc)."""
    torch.cuda.synchronize()
    if got.dtype == torch.float32:
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), err
    else:
        _close(got, want)


@pytest.mark.parametrize("acc_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", _GRAD_SHAPES)
def test_linear_grad_add_kernel(dev, acc_dtype, m, k, n):
    x = _rand(dev, m, k, seed=90)
    dy = _rand(dev, m, n, seed=91)
    acc = _rand(dev, k, n, seed=92, dtype=acc_dtype) * 4
    want = linear_grad_add.linear_grad_add_plain(x, dy, acc.clone())
    before = WRAPPERS["linear_grad_add"].launches
    got = linear_grad_add.linear_grad_add(x, dy, acc)
    assert WRAPPERS["linear_grad_add"].launches == before + 1
    assert got.data_ptr() == acc.data_ptr()           # in place
    _grad_close(got, want)


@pytest.mark.parametrize("m,k,n,split", [
    (37, 136, 264, 1), (4096, 768, 3072, 1), (1000, 1800, 1000, 2),
    (4096, 768, 2304, 2), (4096, 768, 768, 4), (2085, 264, 200, 8),
    (1000, 64, 72, 8), (4096, 256, 1024, 8)])
def test_linear_grad_add_every_split(dev, split, m, k, n):
    """Each cluster split of the token sweep, at two shapes the plan gives
    it (one with tails past every tile), f32 acc."""
    assert linear_grad_add._split(m, k, n) == split
    x, dy = _rand(dev, m, k, seed=93), _rand(dev, m, n, seed=94)
    acc = _rand(dev, k, n, seed=95, dtype=torch.float32) * 4
    want = linear_grad_add.linear_grad_add_plain(x, dy, acc.clone())
    linear_grad_add.linear_grad_add(x, dy, acc)
    _grad_close(acc, want)


@pytest.mark.parametrize("acc_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(4096, 768, 2304), (4096, 768, 768),
                                   (8192, 768, 3072), (1000, 1800, 1000),
                                   (2085, 264, 200), (37, 136, 264)])
def test_linear_grad_add_is_deterministic(dev, acc_dtype, m, k, n):
    """Two calls from the same accumulator return the same bits: the
    cluster's partial tiles are added in rank order, and each acc element
    has one contributor (splits 2, 4, 1, 2, 8 and 1 at these shapes)."""
    x, dy = _rand(dev, m, k, seed=96), _rand(dev, m, n, seed=97)
    acc = _rand(dev, k, n, seed=98, dtype=acc_dtype) * 4
    first = linear_grad_add.linear_grad_add(x, dy, acc.clone())
    second = linear_grad_add.linear_grad_add(x, dy, acc.clone())
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_linear_grad_add_rejects_what_it_does_not_take(dev):
    x = torch.zeros(4, 12, device=dev, dtype=torch.bfloat16)
    dy = torch.zeros(4, 16, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="% 8"):
        linear_grad_add.linear_grad_add(
            x, dy, torch.zeros(12, 16, device=dev))
    with pytest.raises(TypeError):
        linear_grad_add.linear_grad_add(
            x[:, :8].float(), dy.float(), torch.zeros(8, 16, device=dev))


def test_incubate_block_through_kernels(dev):
    """Two post-LN blocks of the incubate ops (hidden 256, 4 heads, S 128,
    p 0.1) forward and backward through the kernels and through the plain
    path after the same seed: the output within 5% of the largest plain
    value, dx and every accumulated main_grad within 5e-2 relative L2, and
    the exact launches of every kernel."""
    from paddle_tpu_torch import seed as seed_all
    from paddle_tpu_torch import incubate
    from paddle_tpu_torch.incubate import nn as inn
    import paddle_tpu_torch.incubate.nn.functional as IF

    hid, heads, s, layers = 256, 4, 128, 2
    mods = []
    for i in range(layers):
        mods.append(dict(
            qkv=inn.FusedLinear(hid, 3 * hid, device=dev,
                                dtype=torch.bfloat16, seed=10 * i),
            out=inn.FusedLinear(hid, hid, bias_attr=False, device=dev,
                                dtype=torch.bfloat16, seed=10 * i + 1),
            ln1=inn.FusedBiasDropoutResidualLayerNorm(
                hid, 0.1, device=dev, dtype=torch.bfloat16),
            fc=inn.FusedLinear(hid, 4 * hid, device=dev,
                               dtype=torch.bfloat16, seed=10 * i + 2),
            proj=inn.FusedLinear(4 * hid, hid, device=dev,
                                 dtype=torch.bfloat16, seed=10 * i + 3),
            add=inn.FusedDropoutAdd(0.1)))
    x0 = _rand(dev, 2, s, hid, seed=95)

    def run(plain):
        seed_all(7)
        grads = {}

        def lin(name, mod, inp):
            out = mod(inp)
            mg = grads.setdefault(name, [
                torch.zeros(mod.weight.shape, device=dev),
                None if mod.bias is None else
                torch.zeros(mod.bias.shape, device=dev)])

            def hook(g):
                IF.fused_linear_param_grad_add(
                    inp, g, mg[0], mg[1], multi_precision=True,
                    has_bias=mg[1] is not None, plain=plain)
            out.register_hook(hook)
            return out

        x = x0.clone().requires_grad_()
        h = x
        for i, m in enumerate(mods):
            with torch.no_grad():
                for mod in m.values():
                    mod.requires_grad_(False)
            qkv = lin(f"{i}.qkv", m["qkv"], h).reshape(2, s, 3, heads, -1)
            q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
            sc = q @ k.transpose(-1, -2) / 8.0
            p = incubate.softmax_mask_fuse_upper_triangle(sc, plain=plain)
            o = (p @ v).transpose(1, 2).reshape(2, s, hid)
            o = lin(f"{i}.out", m["out"], o)
            h1 = m["ln1"](o, h, plain=plain)
            f = lin(f"{i}.fc", m["fc"], h1)
            g = lin(f"{i}.proj", m["proj"],
                    torch.nn.functional.gelu(f))
            h = m["add"](g, h1, plain=plain)
        h.float().square().mean().backward()
        return h.detach(), x.grad, grads

    ref = run(True)
    for w in WRAPPERS.values():
        w.launches = 0
    got = run(False)
    want = {"softmax_mask_tri": 2, "softmax_mask_bwd": 2,
            "bias_dropout_ln": 2, "bias_dropout_ln_bwd": 2,
            "dropout_add": 2, "dropout_add_bwd": 2, "linear_grad_add": 8}
    assert {n: w.launches for n, w in WRAPPERS.items() if w.launches} == want
    err = (got[0].float() - ref[0].float()).abs().max().item()
    assert err <= 0.05 * ref[0].float().abs().max().item(), err
    pairs = [(got[1], ref[1])] + [
        (a, b) for n in ref[2] for a, b in zip(got[2][n], ref[2][n])
        if b is not None]
    for a, b in pairs:
        rel = ((a.float() - b.float()).norm() / b.float().norm()).item()
        assert rel <= 5e-2, rel


# -- the kernel analysis tier on the card (CK200-CK209) ----------------------

@pytest.fixture(scope="module")
def analysis_on_card():
    """Every plane over the port's kernel modules, once for this module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import os
    from paddle_tpu_torch.analysis.kernels import collect
    report = []
    kernels = os.path.dirname(a8w8_matmul.__file__)
    findings, sheets = collect([kernels], report=report)
    return findings, sheets, report


def test_analysis_card_plane_is_clean(analysis_on_card):
    """Every example and its tail launched under the profiler and inside
    guard bands: no unwaived error (bands unchanged, no sentinel left, no
    poison read, the plain result), every launch as declared."""
    from paddle_tpu_torch.analysis.cli import apply_allowlist, load_allowlist
    from paddle_tpu_torch.analysis.kernels import ALLOWLIST_NAME
    findings, _, report = analysis_on_card
    kept, _ = apply_allowlist(findings, load_allowlist(ALLOWLIST_NAME))
    errors = [f"{f.rule_id} {f.message}" for f in kept
              if f.severity == "error"]
    assert errors == []
    assert all(r["kernels"] and "refused" not in r for r in report)
    assert len(report) >= 200


def test_analysis_sheet_for_every_compiled_kernel(analysis_on_card):
    from paddle_tpu_torch.analysis.kernels import parse_resource_usage
    from paddle_tpu_torch.ops.kernels import _build
    _, sheets, _ = analysis_on_card
    named = {(s.library, s.kernel) for s in sheets}
    for lib in _build.SOURCES:
        if lib == "analysis_demo":
            continue
        for u in parse_resource_usage(_build.resource_usage(lib)):
            assert (lib, u.name) in named, (lib, u.name)
    launched = [s for s in sheets if s.label]
    assert all(s.registers and s.fits for s in launched)


def test_analysis_demo_plants_on_the_card():
    """Row 22: the card refuses the overflow; the overlapping writes give
    the copy; the coverage gap leaves the sentinel in rows 128-255; the
    out-of-bounds read brings the poison into the output and changes no
    band."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from paddle_tpu_torch.analysis.kernels import collect, demo
    report = []
    findings, _ = collect([demo.__file__], report=report)
    msgs = [f.message for f in findings]
    by = {r["label"]: r for r in report}
    assert "refused" in by["vmem_overflow"]
    assert by["overlapping_writes"]["max_err"] == 0.0
    assert by["vmem_scalar_mulf"]["max_err"] == 0.0
    assert any("[coverage_gap] 16384 of 32768 elements of o still hold the "
               "sentinel" in m for m in msgs)
    assert any("[oob_read] 16384 NaN in o" in m for m in msgs)
    assert not any("guard band" in m for m in msgs)
