"""paddle_tpu_torch flash attention and block epilogue against the JAX
Pallas kernels.

The same numpy inputs from a seed go through each JAX Pallas kernel in
interpret mode and through the port's wrapper, which on a CPU tensor runs
the kernel's plain PyTorch version. Both sides compute in f32: attention
to 2e-5 (one softmax over the row against the TPU kernel's online one,
another summation order), the epilogue to 1e-5, and the dropout mask
exactly. The CUDA kernels themselves run only on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.kernels import block_fused_pallas as jax_bf
from paddle_tpu.ops.kernels import flash_attention_pallas as jax_fa
from paddle_tpu.ops.kernels.dropout_add_pallas import _fmix32, _GOLDEN, \
    _params
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.kernels import WRAPPERS, block_epilogue, \
    flash_attention

ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
EPI_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    """A CPU tensor takes the plain version: no kernel launch is counted."""
    for w in WRAPPERS.values():
        w.launches = 0
    yield
    assert all(w.launches == 0 for w in WRAPPERS.values())


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# -- flash attention ------------------------------------------------------------

def _segments(rng, b, s):
    """Packed varlen rows: 1-4 segments each, ids ascending."""
    seg = np.zeros((b, s), np.int32)
    for r in range(b):
        cuts = np.sort(rng.choice(np.arange(1, s), size=rng.integers(0, 4),
                                  replace=False))
        for i, c in enumerate(cuts):
            seg[r, c:] = i + 1
    return seg


@pytest.mark.parametrize("s", [16, 256, 512])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("with_seg", [False, True])
def test_flash_plain_matches_pallas(s, causal, with_seg):
    """GQA 4 q heads over 2 kv heads; out and lse of both faces."""
    rng = np.random.default_rng(s * 4 + 2 * causal + with_seg)
    b, h, h_kv, d = 2, 4, 2, 16
    q, k, v = (_rand(rng, b, s, n, d) for n in (h, h_kv, h_kv))
    seg = _segments(rng, b, s) if with_seg else None
    jseg = None if seg is None else jnp.asarray(seg)
    tseg = None if seg is None else torch.from_numpy(seg)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    targs = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))

    want = jax_fa.flash_attention_forward(*args, causal=causal,
                                          interpret=True, segment_ids=jseg)
    got = flash_attention.flash_attention_forward(*targs, causal=causal,
                                                  segment_ids=tseg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)

    want_o, want_lse = jax_fa.flash_attention_forward_lse(
        *args, causal=causal, interpret=True, segment_ids=jseg)
    got_o, got_lse = flash_attention.flash_attention_forward_lse(
        *targs, causal=causal, segment_ids=tseg)
    assert got_lse.shape == (b * h, s) and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **ATTN_TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               **ATTN_TOL)


def test_flash_gqa_rep_one_and_sdpa_face():
    """H == Hkv, and the functional SDPA face (causal, no mask)."""
    rng = np.random.default_rng(3)
    q, k, v = (_rand(rng, 1, 32, 4, 8) for _ in range(3))
    want = jax_fa.flash_attention_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        interpret=True)
    got = F.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        is_causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


def test_flash_ragged_length_matches_prefix_of_longer_run():
    """Any S: a causal run at S = 37 equals the first 37 rows of the same
    run padded to 64 (padding keys sit after every real query)."""
    rng = np.random.default_rng(4)
    q, k, v = (_rand(rng, 1, 64, 2, 16) for _ in range(3))
    full = flash_attention.flash_attention(*(torch.from_numpy(a)
                                             for a in (q, k, v)), True)
    cut = flash_attention.flash_attention(*(torch.from_numpy(a[:, :37])
                                            for a in (q, k, v)), True)
    np.testing.assert_allclose(cut.numpy(), full.numpy()[:, :37], **ATTN_TOL)


def test_flash_and_sdpa_reject_what_they_do_not_take():
    q = torch.zeros(1, 8, 4, 16)
    kv = torch.zeros(1, 8, 3, 16)
    with pytest.raises(ValueError):                       # H % Hkv != 0
        flash_attention.flash_attention(q, kv, kv)
    with pytest.raises(ValueError):                       # seg not int32
        flash_attention.flash_attention(q, q, q, segment_ids=torch.zeros(1, 8))
    with pytest.raises(ValueError):                       # no quiet fallback
        flash_attention.flash_attention(q.to("meta"), q.to("meta"),
                                        q.to("meta"))
    # a mask or dropout takes the composite, which rejects H % Hkv != 0 too
    with pytest.raises(ValueError):
        F.scaled_dot_product_attention(q, kv, kv, attn_mask=torch.ones(8, 8))
    with pytest.raises(ValueError):
        F.scaled_dot_product_attention(q, kv, kv, dropout_p=0.1)
    with pytest.raises(ValueError):                       # flash: no fallback
        F.scaled_dot_product_attention(q.to("meta"), q.to("meta"),
                                       q.to("meta"))


# -- block epilogue -------------------------------------------------------------

EPI_CASES = [
    (None, "rms", 0.0, False),
    (None, "rms", 0.3, False),
    (None, "layer", 0.3, True),
    (None, "layer", 0.0, False),
    ("gelu", "layer", 0.2, True),
    ("gelu", "rms", 0.0, False),
    ("swiglu", "rms", 0.4, False),
    ("swiglu", "layer", 0.1, True),
]


@pytest.mark.parametrize("act,norm,p,bias_on", EPI_CASES)
def test_epilogue_plain_matches_pallas(act, norm, p, bias_on):
    """Every variant of ``_fwd`` (act x norm x bias x dropout) at a shape
    whose rows do not fill the TPU kernel's row block."""
    rng = np.random.default_rng(len(EPI_CASES) + int(p * 10))
    hd = 128
    xw = 2 * hd if act == "swiglu" else hd
    x, res = _rand(rng, 3, 17, xw), _rand(rng, 3, 17, hd)
    w = 1.0 + 0.1 * _rand(rng, hd)
    b = _rand(rng, hd) if bias_on else None
    seed = 42
    want_y, want_h = jax_bf.fused_epilogue(
        jnp.asarray(x), jnp.asarray(res), jnp.asarray(w),
        None if b is None else jnp.asarray(b), jnp.int32(seed), p, 1e-5, act,
        norm, None, True)
    got_y, got_h = block_epilogue.fused_epilogue(
        torch.from_numpy(x), torch.from_numpy(res), torch.from_numpy(w),
        None if b is None else torch.from_numpy(b), seed, p, 1e-5, act, norm)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **EPI_TOL)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **EPI_TOL)
    if p:
        # the dropped positions are the TPU kernel's exactly: with a zero
        # residual, h is 0 exactly where the element was dropped
        _, h0 = jax_bf.fused_epilogue(
            jnp.asarray(x), jnp.zeros_like(jnp.asarray(res)), jnp.asarray(w),
            None if b is None else jnp.asarray(b), jnp.int32(seed), p, 1e-5,
            act, norm, None, True)
        keep = block_epilogue.keep_mask(3 * 17, hd, seed, p).numpy()
        dropped = np.asarray(h0).reshape(3 * 17, hd) == 0.0
        np.testing.assert_array_equal(dropped, ~keep)


@pytest.mark.parametrize("seed", [0, 7, -5, 2**31 - 1])
def test_keep_mask_bit_exact_against_uint32_hash(seed):
    """The int64-carried hash equals the JAX uint32 one bit for bit,
    negative seeds and the wrap of seed * 0x9E3779B9 included."""
    n, hd, p = 37, 96, 0.37
    idx = jnp.arange(n * hd, dtype=jnp.uint32).reshape(n, hd)
    bits = _fmix32(idx ^ (jnp.asarray(seed, jnp.int32).astype(jnp.uint32)
                          * jnp.uint32(_GOLDEN)))
    want = np.asarray(bits >= jnp.uint32(_params(p)[0]))
    got = block_epilogue.keep_mask(n, hd, seed, p).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.3 < 1.0 - got.mean() < 0.45


def test_decode_epilogue_and_functional_face_match_pallas():
    rng = np.random.default_rng(9)
    x, res = _rand(rng, 8, 1, 64), _rand(rng, 8, 1, 64)
    w = 1.0 + 0.1 * _rand(rng, 64)
    want = jax_bf.decode_epilogue(jnp.asarray(x), jnp.asarray(res),
                                  jnp.asarray(w), 1e-5, True)
    for got in (block_epilogue.decode_epilogue(
                    torch.from_numpy(x), torch.from_numpy(res),
                    torch.from_numpy(w), 1e-5),
                F.fused_dropout_add_norm(
                    torch.from_numpy(x), torch.from_numpy(res),
                    torch.from_numpy(w), p=0.5, epsilon=1e-5,
                    training=False)):
        for g, wnt in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(wnt), **EPI_TOL)


@pytest.mark.parametrize("face", ["attn", "mlp"])
def test_attn_and_mlp_faces_match_pallas(face):
    """The two training faces, with dropout and layer norm + bias."""
    rng = np.random.default_rng(10)
    hd = 64
    xw = 2 * hd if face == "mlp" else hd
    x, res = _rand(rng, 4, 5, xw), _rand(rng, 4, 5, hd)
    w, b = 1.0 + 0.1 * _rand(rng, hd), _rand(rng, hd)
    j = [jnp.asarray(a) for a in (x, res, w, b)]
    t = [torch.from_numpy(a) for a in (x, res, w, b)]
    if face == "attn":
        want = jax_bf.attn_epilogue(*j, seed=3, p=0.25, eps=1e-5,
                                    norm="layer", interpret=True)
        got = block_epilogue.attn_epilogue(*t, seed=3, p=0.25, eps=1e-5,
                                           norm="layer")
    else:
        want = jax_bf.mlp_epilogue(*j, seed=3, p=0.25, eps=1e-5,
                                   act="swiglu", norm="layer",
                                   interpret=True)
        got = block_epilogue.mlp_epilogue(*t, seed=3, p=0.25, eps=1e-5,
                                          act="swiglu", norm="layer")
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), **EPI_TOL)


def test_epilogue_rejects_what_it_does_not_take():
    x = torch.zeros(2, 8)
    w = torch.ones(8)
    with pytest.raises(ValueError):
        block_epilogue.fused_epilogue(x, x, w, bias=w)          # rms + bias
    with pytest.raises(ValueError):
        block_epilogue.fused_epilogue(x, x, w, act="swiglu")    # x not [.., 2H]
    with pytest.raises(ValueError):
        block_epilogue.fused_epilogue(x, x, w, act="relu")
    with pytest.raises(ValueError):
        block_epilogue.fused_epilogue(x, x, torch.ones(6))
    with pytest.raises(ValueError):                             # no fallback
        block_epilogue.fused_epilogue(x.to("meta"), x.to("meta"),
                                      w.to("meta"))
