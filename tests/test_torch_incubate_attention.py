"""The masked and dropout ``scaled_dot_product_attention`` of
paddle_tpu_torch and the attention functions of its ``incubate.nn.functional``
against the JAX package's, on the CPU.

The JAX results are computed once for the module (a fixture: each new JAX
configuration compiles for seconds on the CPU); the same seeded numpy
inputs go to both. Tolerance: f32 ``atol``/``rtol`` 2e-4 (the JAX tests'
own). Dropout draws come from the port's generators, not ``jax.random``:
there the keep share and the kept values are checked. No kernel may
launch on the CPU.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate.nn.functional as PIF
import paddle_tpu.nn.functional as PF
import paddle_tpu_torch
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.incubate.nn import memory_efficient_attention
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.kernels import WRAPPERS

TOL = dict(atol=2e-4, rtol=2e-4)


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    for w in WRAPPERS.values():
        w.launches = 0
    yield
    assert not any(w.launches for w in WRAPPERS.values())


def _r(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.numpy())


def _jax(fn, *args, **kw):
    conv = lambda v: paddle.to_tensor(v) if isinstance(v, np.ndarray) \
        else v  # noqa: E731
    return fn(*(conv(a) for a in args), **{k: conv(v) for k, v in kw.items()})


def _port(fn, *args, **kw):
    conv = lambda v: torch.from_numpy(v) if isinstance(v, np.ndarray) \
        else v  # noqa: E731
    return fn(*(conv(a) for a in args), **{k: conv(v) for k, v in kw.items()})


def _cases():
    """name -> (JAX function, port function, args, kwargs), numpy f32."""
    rng = np.random.default_rng(2201)
    q, k, v = _r(rng, 2, 8, 4, 16), _r(rng, 2, 8, 2, 16), _r(rng, 2, 8, 2, 16)
    keep = rng.uniform(size=(2, 1, 8, 8)) < 0.7
    keep[..., 0] = True                        # every row keeps a key
    mq = _r(rng, 1, 530, 2, 8)
    ilens = np.array([8, 5], np.int32)
    kvlens = np.array([0, 6], np.int32)       # row 0 sees no key
    x_mha = _r(rng, 2, 8, 32)
    mask_mha = np.where(rng.uniform(size=(2, 1, 8, 8)) < 0.25, -1e4,
                        0.0).astype(np.float32)
    qkv_w = _r(rng, 3, 4, 8, 32, scale=0.2)
    mha_common = dict(qkv_bias=_r(rng, 3, 4, 8), linear_bias=_r(rng, 32),
                      pre_ln_scale=_r(rng, 32) + 1, pre_ln_bias=_r(rng, 32),
                      ln_scale=_r(rng, 32) + 1, ln_bias=_r(rng, 32),
                      training=False)
    lin_w = _r(rng, 32, 32, scale=0.2)
    gq, gk = _r(rng, 2, 3, 6, 16), _r(rng, 2, 3, 5, 16)
    gate = dict(gate_linear_weight=_r(rng, 16, 2, 4, scale=0.3),
                gate_linear_bias=_r(rng, 2, 4),
                out_linear_weight=_r(rng, 2, 4, 16, scale=0.3),
                out_linear_bias=_r(rng, 16))
    sdpa = (PF.scaled_dot_product_attention, F.scaled_dot_product_attention)
    return {
        "sdpa additive mask, causal, GQA": (
            *sdpa, (q, k, v), dict(attn_mask=_r(rng, 2, 4, 8, 8),
                                   is_causal=True)),
        "sdpa boolean mask": (*sdpa, (q, k, v), dict(attn_mask=keep)),
        "memory_efficient_attention, bias over 2 chunks": (
            PIF.memory_efficient_attention, memory_efficient_attention,
            (mq, mq[:, ::-1].copy(), _r(rng, 1, 530, 2, 8)),
            dict(attn_bias=_r(rng, 1, 2, 530, 530), scale=0.3)),
        "variable_length, GQA, causal, mask, an empty row": (
            PIF.variable_length_memory_efficient_attention,
            IF.variable_length_memory_efficient_attention,
            (_r(rng, 2, 4, 8, 16), _r(rng, 2, 2, 8, 16),
             _r(rng, 2, 2, 8, 16), ilens, kvlens),
            dict(mask=_r(rng, 2, 1, 8, 8), causal=True)),
        "masked_multihead_attention, bias, src_mask, lengths": (
            PIF.masked_multihead_attention, IF.masked_multihead_attention,
            (_r(rng, 3, 3 * 2 * 8),),
            dict(cache_kv=_r(rng, 2, 3, 2, 16, 8), bias=_r(rng, 3, 2, 8),
                 src_mask=_r(rng, 3, 1, 1, 16),
                 sequence_lengths=np.array([[0], [7], [15]], np.int32))),
        "fused_multi_head_attention, pre-LN, mask": (
            PIF.fused_multi_head_attention, IF.fused_multi_head_attention,
            (x_mha, qkv_w, lin_w),
            dict(pre_layer_norm=True, attn_mask=mask_mha, **mha_common)),
        "fused_multi_head_attention, post-LN, [D, 3D] weight": (
            PIF.fused_multi_head_attention, IF.fused_multi_head_attention,
            (x_mha, qkv_w.reshape(96, 32).T.copy(), lin_w),
            dict(transpose_qkv_wb=True, num_heads=4, attn_mask=mask_mha,
                 **{**mha_common, "qkv_bias": mha_common["qkv_bias"]
                    .reshape(-1)})),
        "fused_gate_attention, merged qkv, biases": (
            PIF.fused_gate_attention, IF.fused_gate_attention, (gq,),
            dict(qkv_weight=_r(rng, 3, 2, 4, 16, scale=0.3),
                 nonbatched_bias=_r(rng, 2, 1, 2, 6, 6),
                 attn_mask=_r(rng, 2, 3, 1, 1, 6), **gate)),
        "fused_gate_attention, separate projections": (
            PIF.fused_gate_attention, IF.fused_gate_attention, (gq,),
            dict(key=gk, query_weight=_r(rng, 16, 2, 4, scale=0.3),
                 key_weight=_r(rng, 16, 2, 4, scale=0.3),
                 value_weight=_r(rng, 16, 2, 4, scale=0.3), merge_qkv=False,
                 **gate)),
    }


CASES = _cases()


@pytest.fixture(scope="module")
def jax_refs():
    out = {}
    for name, (jfn, _, args, kw) in CASES.items():
        got = _jax(jfn, *args, **kw)
        out[name] = [_np(t) for t in (got if isinstance(got, (tuple, list))
                                      else (got,))]
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax(jax_refs, name):
    _, pfn, args, kw = CASES[name]
    got = _port(pfn, *args, **kw)
    got = got if isinstance(got, (tuple, list)) else (got,)
    assert len(got) == len(jax_refs[name])
    for g, want in zip(got, jax_refs[name]):
        np.testing.assert_allclose(_np(g), want, **TOL)


def test_sdpa_without_mask_or_dropout_is_the_flash_path():
    """No mask, no dropout (or dropout in eval): the flash kernel's path
    (its plain version here), the composite's function."""
    rng = np.random.default_rng(2202)
    q, k, v = (torch.from_numpy(_r(rng, 2, 8, 4, 16)) for _ in range(3))
    flash = F.flash_attention(q, k, v, causal=True)
    for kw in ({}, dict(dropout_p=0.5, training=False)):
        torch.testing.assert_close(
            F.scaled_dot_product_attention(q, k, v, is_causal=True, **kw),
            flash, atol=0, rtol=0)
    np.testing.assert_allclose(
        _np(F.sdpa_composite(q, k, v, is_causal=True)), _np(flash), **TOL)


def test_sdpa_dropout_keeps_each_probability_or_zeroes_it():
    """With V the identity over keys, the output is the dropped
    probabilities: each is 0 or the undropped one over 1 - p, about
    1 - p of them are kept, and the same seed draws the same mask."""
    rng = np.random.default_rng(2203)
    b, s, h, t, p = 2, 64, 4, 32, 0.25
    q = torch.from_numpy(_r(rng, b, s, h, 32))
    k = torch.from_numpy(_r(rng, b, t, h, 32))
    v = torch.eye(t).expand(b, h, t, t).permute(0, 2, 1, 3).contiguous()
    mask = torch.zeros(b, 1, s, t)                # forces the composite
    probs = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    paddle_tpu_torch.seed(7)
    got = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                         dropout_p=p)
    paddle_tpu_torch.seed(7)
    again = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                           dropout_p=p)
    torch.testing.assert_close(got, again, atol=0, rtol=0)
    kept = got != 0
    assert abs(kept.float().mean().item() - (1 - p)) < 0.02
    torch.testing.assert_close(got[kept], probs[kept] / (1 - p), atol=1e-6,
                               rtol=1e-6)


def test_sdpa_gqa_repeats_kv_heads():
    rng = np.random.default_rng(2204)
    q, k, v = (torch.from_numpy(_r(rng, 1, 6, 4, 8)),
               torch.from_numpy(_r(rng, 1, 6, 2, 8)),
               torch.from_numpy(_r(rng, 1, 6, 2, 8)))
    mask = torch.zeros(1, 1, 6, 6)
    torch.testing.assert_close(
        F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
        F.scaled_dot_product_attention(q, k.repeat_interleave(2, 2),
                                       v.repeat_interleave(2, 2),
                                       attn_mask=mask))
    with pytest.raises(ValueError, match="multiple"):
        F.sdpa_composite(q, k[:, :, :1].expand(1, 6, 3, 8), v, mask)


def test_linear_relu_softmax_match_jax():
    rng = np.random.default_rng(2205)
    x, w, b = _r(rng, 3, 5, 8), _r(rng, 8, 6), _r(rng, 6)
    np.testing.assert_allclose(_np(_port(F.linear, x, w, b)),
                               _np(_jax(PF.linear, x, w, b)), **TOL)
    np.testing.assert_allclose(_np(_port(F.relu, x)), _np(_jax(PF.relu, x)))
    np.testing.assert_allclose(_np(_port(F.softmax, x, axis=1)),
                               _np(_jax(PF.softmax, x, axis=1)), **TOL)


def test_memory_efficient_attention_without_bias_is_attention():
    """One chunk and two, no bias: plain softmax attention."""
    rng = np.random.default_rng(2206)
    for s in (40, 700):
        q, k, v = (torch.from_numpy(_r(rng, 1, s, 2, 8)) for _ in range(3))
        np.testing.assert_allclose(
            _np(memory_efficient_attention(q, k, v)),
            _np(F.sdpa_composite(q, k, v, torch.zeros(1, 1, s, s))), **TOL)


def test_memory_efficient_attention_dropout_is_on_the_output():
    rng = np.random.default_rng(2207)
    q, k, v = (torch.from_numpy(_r(rng, 2, 16, 2, 8)) for _ in range(3))
    full = memory_efficient_attention(q, k, v)
    paddle_tpu_torch.seed(3)
    got = memory_efficient_attention(q, k, v, p=0.5)
    kept = got != 0
    torch.testing.assert_close(got[kept], full[kept] * 2)
    torch.testing.assert_close(memory_efficient_attention(
        q, k, v, p=0.5, training=False), full)


@pytest.mark.parametrize("kw", [dict(qkv_out_scale=np.ones(3, np.float32)),
                                dict(out_scale=1.0), dict(rotary_emb_dims=1),
                                dict(beam_cache_offset=np.zeros(1))])
def test_masked_multihead_attention_raises_like_jax(kw):
    x = np.zeros((1, 3 * 8), np.float32)
    cache = np.zeros((2, 1, 1, 4, 8), np.float32)
    with pytest.raises(NotImplementedError, match="not supported"):
        _port(IF.masked_multihead_attention, x, cache_kv=cache, **kw)
    with pytest.raises(ValueError, match="cache_kv"):
        _port(IF.masked_multihead_attention, x)


def test_masked_multihead_attention_leaves_the_given_cache():
    """The cache comes back as a new tensor, as JAX's (the given one is
    not written)."""
    rng = np.random.default_rng(2208)
    cache = torch.from_numpy(_r(rng, 2, 2, 2, 8, 4))
    before = cache.clone()
    _, new = IF.masked_multihead_attention(
        torch.from_numpy(_r(rng, 2, 24)), cache_kv=cache,
        sequence_lengths=torch.tensor([3, 5]))
    torch.testing.assert_close(cache, before, atol=0, rtol=0)
    assert not torch.equal(new, before)


def test_fused_multi_head_attention_raises_like_jax():
    x, w = torch.zeros(1, 4, 16), torch.zeros(3, 2, 8, 16)
    lw = torch.zeros(16, 16)
    for kw in (dict(cache_kv=torch.zeros(2, 1, 2, 4, 8)), dict(ring_id=0)):
        with pytest.raises(NotImplementedError, match="cache_kv/ring_id"):
            IF.fused_multi_head_attention(x, w, lw, **kw)
    with pytest.raises(ValueError, match="num_heads"):
        IF.fused_multi_head_attention(x, torch.zeros(16, 48), lw,
                                      transpose_qkv_wb=True)
