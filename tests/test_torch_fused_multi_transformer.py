"""``fused_multi_transformer`` of paddle_tpu_torch against the JAX
package's, on the CPU, and the contiguous mmha entry it decodes through.

The JAX references are computed once for the module (a fixture): each new
configuration of the JAX function compiles for seconds on the CPU. The
same numpy weights and inputs go to both. Tolerances are the JAX tests'
own (``tests/test_fused_serving.py``): f32 ``atol``/``rtol`` 2e-4, decode
5e-4. On the CPU the decode step takes the kernel's plain version
(``mmha.reference_mmha``), so no kernel launch may be counted.

The port differs from JAX on purpose in two places held here: an
``attn_mask`` given with ``pre_caches`` is added over the prefix and live
blocks (JAX replaces it with its causal mask, so the JAX result differs
there: the test says so), and the decode step updates the caller's caches
in place (JAX returns new buffers).
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import paddle_tpu as paddle
import paddle_tpu.incubate.nn as pinn
from paddle_tpu.incubate.nn.functional import \
    fused_multi_transformer as jax_fmt
from paddle_tpu.ops.kernels import mmha_pallas
from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
from paddle_tpu_torch.incubate.nn.functional import fused_multi_transformer
from paddle_tpu_torch.models import incubate_from_jax_state
from paddle_tpu_torch.ops.kernels import WRAPPERS, mmha

TOL = dict(atol=2e-4, rtol=2e-4)
DECODE_TOL = dict(atol=5e-4, rtol=5e-4)
L, B, S, NH, HD, DFF, T, C = 2, 2, 5, 2, 8, 32, 16, 3
D = NH * HD
KEYS = ("ln_s", "ln_b", "qkv_w", "qkv_b", "lin_w", "lin_b", "fln_s",
        "fln_b", "f1_w", "f1_b", "f2_w", "f2_b")


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    for w in WRAPPERS.values():
        w.launches = 0
    yield
    assert not any(w.launches for w in WRAPPERS.values())


def _weights(rng):
    def t(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)
    shapes = {"ln_s": (D,), "ln_b": (D,), "qkv_w": (3, NH, HD, D),
              "qkv_b": (3, NH, HD), "lin_w": (NH * HD, D), "lin_b": (D,),
              "fln_s": (D,), "fln_b": (D,), "f1_w": (D, DFF), "f1_b": (DFF,),
              "f2_w": (DFF, D), "f2_b": (D,)}
    w = {k: [t(*shapes[k]) for _ in range(L)] for k in KEYS}
    for k in ("ln_s", "fln_s"):
        w[k] = [a + 1.0 for a in w[k]]
    return w


def _rotary(rng, s):
    ang = rng.uniform(0, 6.3, (B, 1, s, HD // 2))
    ang = np.concatenate([ang, ang], axis=-1)
    return np.stack([np.cos(ang), np.sin(ang)]).astype(np.float32)


def _jax_call(w, x, **kw):
    ws = [[paddle.to_tensor(a) for a in w[k]] for k in KEYS]
    conv = {k: (paddle.to_tensor(v) if isinstance(v, np.ndarray) else
                [paddle.to_tensor(a) for a in v] if isinstance(v, list)
                else v) for k, v in kw.items()}
    return jax_fmt(paddle.to_tensor(x), *ws, **conv)


def _port_call(w, x, **kw):
    ws = [[torch.tensor(a) for a in w[k]] for k in KEYS]
    conv = {k: (torch.tensor(v) if isinstance(v, np.ndarray) else
                [torch.tensor(a) if isinstance(a, np.ndarray) else a
                 for a in v] if isinstance(v, list) else v)
            for k, v in kw.items()}
    return fused_multi_transformer(torch.tensor(x), *ws, **conv)


def _port_prefill(case):
    """The port's prefill of the first S positions into zero caches, with
    rotary tables and ``seq_lens``: (out, caches)."""
    zeros = [torch.zeros(2, B, NH, T, HD) for _ in range(L)]
    out, caches = _port_call(case["w"], case["full"][:, :S], cache_kvs=zeros,
                             rotary_embs=case["rot"][..., :S, :],
                             rotary_emb_dims=1, seq_lens=case["lens"])
    assert all(c is z for c, z in zip(caches, zeros))  # in place
    return out, caches


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t.numpy())


@pytest.fixture(scope="module")
def case():
    """Seeded weights and inputs, and every JAX result the module checks."""
    rng = np.random.default_rng(22)
    w = _weights(rng)
    full = rng.standard_normal((B, S + 1, D)).astype(np.float32)
    rot = _rotary(rng, S + 1)
    lens = np.array([S, S - 2], np.int32)
    pre = [(rng.standard_normal((2, B, NH, C, HD)) * 0.5).astype(np.float32)
           for _ in range(L)]
    c = dict(w=w, full=full, rot=rot, lens=lens, pre=pre)
    j = c["jax"] = {}
    j["prefill"] = _np(_jax_call(w, full[:, :S], rotary_embs=rot[..., :S, :],
                                 rotary_emb_dims=1, seq_lens=lens))
    # JAX decodes from the caches the port's prefill wrote (the same numpy)
    c["prefill_caches"] = [_np(t) for t in _port_prefill(c)[1]]
    out, caches = _jax_call(w, full[:, S:], cache_kvs=c["prefill_caches"],
                            rotary_embs=rot[..., S:, :], rotary_emb_dims=1,
                            time_step=np.array([S], np.int32))
    j["decode"], j["decode_caches"] = _np(out), [_np(t) for t in caches]
    # the prefill's S positions again: shapes JAX has compiled for already
    j["post"] = _np(_jax_call(w, full[:, :S], pre_layer_norm=False,
                              activation="relu", dropout_rate=0.25,
                              mode="downscale_in_infer"))
    j["pre_caches"] = _np(_jax_call(w, full[:, :S], pre_caches=pre))
    return c


# -- prefill and decode against JAX ---------------------------------------------

def test_prefill_with_caches_rotary_and_seq_lens_matches_jax(case):
    """The prefill's output against JAX's; its caches hold the first S
    positions (the rotated keys), zeros after, and JAX's decode step from
    them is the port's (next test)."""
    out, caches = _port_prefill(case)
    np.testing.assert_allclose(_np(out), case["jax"]["prefill"], **TOL)
    for c in caches:
        assert c[:, :, :, :S].abs().amax() > 0 and not c[:, :, :, S:].any()


def test_decode_step_matches_jax_and_writes_the_callers_cache(case):
    caches = [torch.tensor(c) for c in case["prefill_caches"]]
    out, got = _port_call(case["w"], case["full"][:, S:], cache_kvs=caches,
                          rotary_embs=case["rot"][..., S:, :],
                          rotary_emb_dims=1,
                          time_step=torch.tensor([S], dtype=torch.int32))
    np.testing.assert_allclose(_np(out), case["jax"]["decode"], **DECODE_TOL)
    for g, c, want in zip(got, caches, case["jax"]["decode_caches"]):
        assert g is c
        np.testing.assert_allclose(_np(c), want, **DECODE_TOL)


@pytest.mark.parametrize("trans_qkvw", [True, False])
def test_post_ln_relu_downscale_in_infer_matches_jax(case, trans_qkvw):
    """Post-LN, relu, eval with ``downscale_in_infer`` (each dropout site
    scaled by 1 - p); ``trans_qkvw=False`` takes the same projection as
    ``[E, 3, H, hd]``."""
    w = dict(case["w"])
    if not trans_qkvw:
        w["qkv_w"] = [a.reshape(3 * NH * HD, D).T.reshape(D, 3, NH, HD)
                      for a in w["qkv_w"]]
    got = _port_call(w, case["full"][:, :S], pre_layer_norm=False,
                     activation="relu", dropout_rate=0.25,
                     mode="downscale_in_infer", trans_qkvw=trans_qkvw)
    np.testing.assert_allclose(_np(got), case["jax"]["post"], **TOL)


def test_pre_caches_match_jax(case):
    got = _port_call(case["w"], case["full"][:, :S], pre_caches=case["pre"])
    np.testing.assert_allclose(_np(got), case["jax"]["pre_caches"], **TOL)


def test_each_decode_step_equals_the_one_shot_prefill(case):
    """Prefill 3 positions, then decode positions 3..5 one at a time: each
    step's output is the one-shot prefill's at its position (the JAX test's
    pattern, at the decode tolerance)."""
    x = torch.tensor(case["full"])
    ref = _port_call(case["w"], case["full"])
    caches = [torch.zeros(2, B, NH, T, HD) for _ in range(L)]
    w = [[torch.tensor(a) for a in case["w"][k]] for k in KEYS]
    out, caches = fused_multi_transformer(x[:, :3], *w, cache_kvs=caches)
    np.testing.assert_allclose(_np(out), _np(ref[:, :3]), **TOL)
    for t in range(3, S + 1):
        out, caches = fused_multi_transformer(x[:, t:t + 1], *w,
                                              cache_kvs=caches, time_step=t)
        np.testing.assert_allclose(_np(out), _np(ref[:, t:t + 1]),
                                   **DECODE_TOL)


def test_attn_mask_with_pre_caches_is_added_over_both_blocks(case):
    """The reference's defect (``ADVICE.md``): JAX drops a caller's mask
    when ``pre_caches`` are given. The port adds it over the prefix and
    live blocks, held here against an unfused oracle with the mask; the
    JAX result differs there."""
    rng = np.random.default_rng(5)
    x = case["full"][:, :S]
    mask = np.where(rng.uniform(size=(B, 1, S, C + S)) < 0.3,
                    -1e9, 0.0).astype(np.float32)
    mask[..., 0] = 0.0                     # every row keeps a key
    got = _np(_port_call(case["w"], x, pre_caches=case["pre"],
                         attn_mask=mask))
    want = _oracle(case["w"], x, case["pre"], mask)
    np.testing.assert_allclose(got, want, **TOL)
    live = mask[..., C:]                   # a mask over the live block alone
    got_live = _np(_port_call(case["w"], x, pre_caches=case["pre"],
                              attn_mask=live))
    want_live = _oracle(case["w"], x, case["pre"],
                        np.pad(live, ((0, 0),) * 3 + ((C, 0),)))
    np.testing.assert_allclose(got_live, want_live, **TOL)
    assert np.abs(got - case["jax"]["pre_caches"]).max() > 1e-3


def _oracle(w, x, pre, mask):
    """Plain numpy pre-LN gelu layers with ``pre`` prepended to each
    layer's keys and values and ``mask`` added to the logits."""
    from math import erf, sqrt
    gelu = np.vectorize(lambda v: 0.5 * v * (1.0 + erf(v / sqrt(2.0))))

    def ln(v, g, b):
        mu = v.mean(-1, keepdims=True)
        var = ((v - mu) ** 2).mean(-1, keepdims=True)
        return (v - mu) / np.sqrt(var + 1e-5) * g + b

    out = x.astype(np.float64)
    b, s, _ = x.shape
    for i in range(L):
        h = ln(out, w["ln_s"][i], w["ln_b"][i])
        qkv = h @ w["qkv_w"][i].reshape(3 * NH * HD, D).T \
            + w["qkv_b"][i].reshape(-1)
        qkv = qkv.reshape(b, s, 3, NH, HD)
        q = qkv[:, :, 0]
        k = np.concatenate([pre[i][0].transpose(0, 2, 1, 3), qkv[:, :, 1]], 1)
        v = np.concatenate([pre[i][1].transpose(0, 2, 1, 3), qkv[:, :, 2]], 1)
        logits = np.einsum("bshd,bthd->bhst", q, k) / np.sqrt(HD) + mask
        p = np.exp(logits - logits.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        att = np.einsum("bhst,bthd->bshd", p, v).reshape(b, s, NH * HD)
        out = out + att @ w["lin_w"][i] + w["lin_b"][i]
        h = ln(out, w["fln_s"][i], w["fln_b"][i])
        out = out + gelu(h @ w["f1_w"][i] + w["f1_b"][i]) @ w["f2_w"][i] \
            + w["f2_b"][i]
    return out.astype(np.float32)


def test_pre_caches_with_time_step_raises(case):
    caches = [torch.zeros(2, B, NH, T, HD) for _ in range(L)]
    with pytest.raises(NotImplementedError, match="pre_caches"):
        _port_call(case["w"], case["full"][:, :1], cache_kvs=caches,
                   pre_caches=case["pre"], time_step=1)


def test_training_dropout_draws_from_the_default_generator(case):
    """In training, dropout draws come from the port's generator: the same
    seed gives the same output, another seed another, and every value is
    finite."""
    import paddle_tpu_torch
    outs = []
    for seed in (1, 1, 2):
        paddle_tpu_torch.seed(seed)
        outs.append(_np(_port_call(case["w"], case["full"], training=True,
                                   dropout_rate=0.5)))
    assert np.isfinite(outs[0]).all()
    np.testing.assert_array_equal(outs[0], outs[1])
    assert np.abs(outs[0] - outs[2]).max() > 1e-3


# -- the layer and its JAX state --------------------------------------------------

#: the JAX layer's per-layer lists, in the order of the function's arguments
LISTS = ("ln_scales", "ln_biases", "qkv_weights", "qkv_biases",
         "linear_weights", "linear_biases", "ffn_ln_scales", "ffn_ln_biases",
         "ffn1_weights", "ffn1_biases", "ffn2_weights", "ffn2_biases")


def test_layer_loads_jax_state_and_matches(case):
    """The JAX layer's ``state_dict()`` keys and shapes are the port's;
    the module's weights under those keys load with no transposition, and
    the layer's forward (with ``pre_caches``) is JAX's function's. (The
    JAX layer is built with constant initializers: only its keys and
    shapes are read, and its random draws compile for seconds.)"""
    zero = paddle.ParamAttr(initializer=paddle.nn.initializer.Constant(0.0))
    jl = pinn.FusedMultiTransformer(
        D, NH, DFF, num_layers=L,
        **{(name[:-2] if name.endswith("biases") else name[:-1]) + "_attrs":
           zero for name in LISTS})
    jax_shapes = {k: tuple(v.shape) for k, v in jl.state_dict().items()}
    port = FusedMultiTransformer(D, NH, DFF, num_layers=L, device="cpu")
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == \
        jax_shapes
    state = {f"{name}_{i}": case["w"][key][i]
             for name, key in zip(LISTS, KEYS) for i in range(L)}
    assert set(state) == set(jax_shapes)
    incubate_from_jax_state(port, state)
    port.eval()
    got = port(torch.tensor(case["full"][:, :S]),
               pre_caches=[torch.tensor(p) for p in case["pre"]])
    np.testing.assert_allclose(_np(got), case["jax"]["pre_caches"], **TOL)


# -- the contiguous mmha entry ----------------------------------------------------

def test_contiguous_plain_path_matches_the_jax_reference():
    rng = np.random.default_rng(7)
    q = rng.standard_normal((3, 1, 8, 64)).astype(np.float32)
    k = rng.standard_normal((3, 2, 48, 64)).astype(np.float32)
    v = rng.standard_normal((3, 2, 48, 64)).astype(np.float32)
    pos = np.array([0, 17, 47], np.int32)
    got = mmha.mmha_decode_contiguous(torch.tensor(q), torch.tensor(k),
                                      torch.tensor(v), torch.tensor(pos))
    want = mmha_pallas.reference_mmha(*(paddle.to_tensor(a)._data
                                        for a in (q, k, v, pos)))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def _kernel_pages(flat, tables, page_stride, head_stride, h_kv, ps, d):
    """What the kernel reads: page ``tables[b, j]`` of kv head ``g`` from
    ``flat[page_id * page_stride + g * head_stride:][:ps * d]``, assembled
    as ``[B, Hkv, max_pages * ps, D]``."""
    b, n = tables.shape
    out = torch.empty(b, h_kv, n * ps, d)
    for row in range(b):
        for g in range(h_kv):
            for j in range(n):
                at = int(tables[row, j]) * page_stride + g * head_stride
                out[row, g, j * ps:(j + 1) * ps] = \
                    flat[at:at + ps * d].reshape(ps, d)
    return out


@pytest.mark.parametrize("b,h_kv,t,d", [(2, 3, 64, 64), (3, 1, 32, 128)])
def test_contiguous_table_and_strides_address_the_callers_cache(b, h_kv, t,
                                                                d):
    """The contiguous entry's table and strides ``(ps * D, T * D)`` make
    the kernel's page address ``page_id * page_stride + g * head_stride``
    land on ``k_buf[b, g, j * ps:(j + 1) * ps]``; the pool's strides
    ``(Hkv * ps * D, ps * D)`` land on the pool's pages, as before."""
    ps = mmha.CONTIGUOUS_PAGE
    k_buf = torch.randn(b, h_kv, t, d)
    tab = mmha.contiguous_table(b, h_kv, t, "cpu")
    assert tab.dtype == torch.int32 and tuple(tab.shape) == (b, t // ps)
    assert tab is mmha.contiguous_table(b, h_kv, t, "cpu")     # cached
    got = _kernel_pages(k_buf.reshape(-1), tab, ps * d, t * d, h_kv, ps, d)
    torch.testing.assert_close(got, k_buf, atol=0, rtol=0)
    tables, _, n_pages = mmha.paged_tables([t - 3] * b, ps, t // ps, seed=1)
    pool = torch.randn(n_pages, h_kv, ps, d)
    got = _kernel_pages(pool.reshape(-1), tables, h_kv * ps * d, ps * d,
                        h_kv, ps, d)
    torch.testing.assert_close(got, mmha.gather_pages(pool, tables), atol=0,
                               rtol=0)


@pytest.mark.parametrize("what", ["f32", "D 96", "H % Hkv", "T 40", "strided",
                                  "pos int64"])
def test_contiguous_kernel_checks_raise(what):
    with FakeTensorMode():
        bf = torch.bfloat16
        d = 96 if what == "D 96" else 64
        t = 40 if what == "T 40" else 64
        e = lambda *s, dt=bf: torch.empty(*s, dtype=dt, device="cuda")  # noqa: E731
        # every H / Hkv runs; 5 query heads over 2 kv heads do not divide
        q, kb = e(2, 1, 5 if what == "H % Hkv" else 4, d), e(2, 2, t, d)
        pos = e(2, dt=torch.int64 if what == "pos int64" else torch.int32)
        err = ValueError
        if what == "f32":
            q, kb, err = q.float(), kb.float(), TypeError
        if what == "strided":
            kb = e(2, 2, d, t).transpose(2, 3)
        with pytest.raises(err):
            mmha.mmha_decode_contiguous(q, kb, kb, pos)
