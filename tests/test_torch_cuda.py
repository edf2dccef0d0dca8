"""paddle_tpu_torch CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one. On the GPU:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerance: one bf16 ulp of the largest reference magnitude
(``2**-7 * max|ref|``) — kernel and plain version do the same f32
arithmetic and round once to bf16, in another order. The flash kernel
carries the probabilities into ``P V`` with 16 significant bits (a
two-term bf16 split), far inside that tolerance; its log-sum-exp is f32
and is held to 1e-4. The block epilogue's dropout mask is held exactly.
"""

import pytest
import torch

from paddle_tpu_torch.models import llama_tiny
from paddle_tpu_torch.ops.kernels import WRAPPERS, block_epilogue, \
    flash_attention, mmha, rms_norm, rope, swiglu
from paddle_tpu_torch.serving import LLMEngine, ServingConfig

pytestmark = pytest.mark.cuda


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


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
def test_mmha_kernel(dev, d, rep):
    lengths, h_kv, ps, max_pages = [1, 40, 0, 333, 16], 2, 16, 24
    need = [-(-n // ps) for n in lengths]
    n_pages = 1 + sum(need)
    perm = (torch.randperm(n_pages - 1) + 1).tolist()
    tables = torch.zeros(len(lengths), max_pages, dtype=torch.int32)
    nxt = 0
    for r, k in enumerate(need):
        tables[r, :k] = torch.tensor(perm[nxt:nxt + k], dtype=torch.int32)
        nxt += k
    tables = tables.to(dev)
    pos = torch.tensor([max(n - 1, 0) for n in lengths], dtype=torch.int32,
                       device=dev)
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
    assert all(w.launches > 0 for w in WRAPPERS.values())
