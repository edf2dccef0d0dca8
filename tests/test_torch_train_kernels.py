"""paddle_tpu_torch backward and optimizer kernels against the JAX Pallas
kernels, on the CPU.

The same numpy inputs from a seed go through each JAX Pallas kernel in
interpret mode (through ``jax.vjp`` of its custom_vjp where it has one)
and through the port's wrapper, which on a CPU tensor runs the kernel's
plain PyTorch version. Both sides compute in f32. Tolerance: 1e-5 for the
row kernels and AdamW (the same arithmetic in another order); 1e-4 for
flash attention, whose sums over the keys run in another order and over
another blocking. Each autograd Function's backward is also held against
torch autograd of its plain forward on the same inputs. No kernel may
launch on the CPU. The CUDA kernels themselves run only on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.kernels import (adamw_pallas, flash_attention_pallas,
                                    rms_norm_pallas, rope_pallas,
                                    swiglu_pallas)
from paddle_tpu_torch.ops.kernels import (WRAPPERS, adamw, flash_attention,
                                          rms_norm, rope, swiglu)

TOL = dict(rtol=1e-5, atol=1e-5)
FLASH_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    """A CPU tensor takes the plain version: no kernel launch is counted."""
    for w in WRAPPERS.values():
        w.launches = 0
    yield
    assert {n: w.launches for n, w in WRAPPERS.items()} == \
        {n: 0 for n in WRAPPERS}


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a, grad=False):
    return torch.tensor(a, requires_grad=grad)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


# -- rms_norm -------------------------------------------------------------------

@pytest.mark.parametrize("rows,hidden", [(1, 64), (10, 64), (37, 200)])
@pytest.mark.parametrize("residual", [False, True])
def test_rms_norm_bwd_matches_pallas_vjp(rows, hidden, residual):
    rng = np.random.default_rng(rows * 100 + hidden + residual)
    x, w = _rand(rng, rows, hidden), 1.0 + _rand(rng, hidden, scale=0.1)
    g = _rand(rng, rows, hidden)
    eps = 1e-5
    if residual:
        r, g_h = _rand(rng, rows, hidden), _rand(rng, rows, hidden)
        (_, h_j), vjp = jax.vjp(
            lambda a, b, c: rms_norm_pallas.rms_norm_fused(a, b, c, eps, True),
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(r))
        dx_j, dw_j, dr_j = vjp((jnp.asarray(g), jnp.asarray(g_h)))
        np.testing.assert_allclose(np.asarray(dr_j), np.asarray(dx_j))
        h = _t(np.asarray(h_j))
        dx, dw = rms_norm.rms_norm_bwd(h, _t(w), _t(g), _t(g_h), eps)
    else:
        _, vjp = jax.vjp(
            lambda a, b: rms_norm_pallas.rms_norm_fused(a, b, None, eps,
                                                        True)[0],
            jnp.asarray(x), jnp.asarray(w))
        dx_j, dw_j = vjp(jnp.asarray(g))
        dx, dw = rms_norm.rms_norm_bwd(_t(x), _t(w), _t(g), None, eps)
    _close(dx, dx_j)
    _close(dw, dw_j)


@pytest.mark.parametrize("residual", [False, True])
def test_rms_norm_function_matches_autograd_of_plain(residual):
    rng = np.random.default_rng(3 + residual)
    x, w = _rand(rng, 3, 5, 64), 1.0 + _rand(rng, 64, scale=0.1)
    r = _rand(rng, 3, 5, 64) if residual else None
    cots = [_rand(rng, 3, 5, 64) for _ in range(1 + residual)]

    def run(fn):
        ins = [_t(x, True), _t(w, True)] + ([_t(r, True)] if residual else [])
        out = fn(*ins)
        outs = out if residual else (out,)
        return torch.autograd.grad(outs, ins, [_t(c) for c in cots])

    def plain(a, b, c=None):
        return rms_norm.rms_norm_plain(a, b, c, 1e-5)

    def function(a, b, c=None):
        return rms_norm.RMSNormFunction.apply(a, b, c, 1e-5, False)

    for got, want in zip(run(function), run(plain)):
        _close(got, want.numpy())


def test_rms_norm_bwd_rejects_bad_inputs():
    h, w = torch.zeros(4, 8), torch.ones(8)
    with pytest.raises(ValueError):
        rms_norm.rms_norm_bwd(h, w, torch.zeros(4, 6))
    with pytest.raises(ValueError):
        rms_norm.rms_norm_bwd(h, w, torch.zeros(4, 8).double())
    with pytest.raises(ValueError):        # no quiet fallback off the CPU
        rms_norm.rms_norm_bwd(h.to("meta"), w.to("meta"),
                              torch.zeros(4, 8, device="meta"))


# -- swiglu ---------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(10, 128), (3, 7, 256), (1, 24)])
def test_swiglu_bwd_matches_pallas_vjp(shape):
    rng = np.random.default_rng(sum(shape))
    g, u, dy = 3 * _rand(rng, *shape), _rand(rng, *shape), _rand(rng, *shape)
    _, vjp = jax.vjp(lambda a, b: swiglu_pallas.swiglu_fused(a, b, True),
                     jnp.asarray(g), jnp.asarray(u))
    dg_j, du_j = vjp(jnp.asarray(dy))
    dg, du = swiglu.swiglu_bwd(_t(g), _t(u), _t(dy))
    _close(dg, dg_j)
    _close(du, du_j)
    # the Function's backward against autograd of the plain forward
    ins = [_t(g, True), _t(u, True)]
    got = torch.autograd.grad(swiglu.SwiGLUFunction.apply(*ins, False), ins,
                              _t(dy))
    ins = [_t(g, True), _t(u, True)]
    want = torch.autograd.grad(swiglu.swiglu_plain(*ins), ins, _t(dy))
    for a, b in zip(got, want):
        _close(a, b.numpy())


def test_swiglu_bwd_rejects_bad_inputs():
    with pytest.raises(ValueError):
        swiglu.swiglu_bwd(torch.zeros(2, 8), torch.zeros(2, 8),
                          torch.zeros(2, 4))
    with pytest.raises(ValueError):
        z = torch.zeros(2, 8, device="meta")
        swiglu.swiglu_bwd(z, z, z)


# -- rope -----------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 5, 4, 16), (1, 13, 2, 32)])
def test_rope_vjp_matches_pallas(shape):
    rng = np.random.default_rng(sum(shape))
    b, s, h, d = shape
    x, dy = _rand(rng, *shape), _rand(rng, *shape)
    ang = rng.uniform(0, 6.3, (s, d // 2))
    ang = np.concatenate([ang, ang], axis=-1)
    cos, sin = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    _, vjp = jax.vjp(lambda a: rope_pallas.rope_apply(
        a, jnp.asarray(cos), jnp.asarray(sin), True), jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(dy))
    xt = _t(x, True)
    out, _ = rope.RoPEFunction.apply(xt, None, _t(cos), _t(sin), False)
    (dx,) = torch.autograd.grad(out, xt, _t(dy))
    _close(dx, dx_j)
    xt = _t(x, True)
    (want,) = torch.autograd.grad(rope.rope_plain(xt, _t(cos), _t(sin)), xt,
                                  _t(dy))
    _close(dx, want.numpy())


# -- flash attention ----------------------------------------------------------------

FLASH_CASES = [
    # b, s, h, h_kv, d, causal, segments
    (1, 64, 4, 2, 64, True, False),
    (2, 128, 4, 1, 64, False, False),
    (1, 256, 2, 1, 128, True, False),
    (2, 128, 4, 2, 128, True, True),
    (1, 128, 4, 4, 64, False, True),
]


def _segments(b, s):
    seg = np.zeros((b, s), np.int32)
    seg[0, s // 3:], seg[0, s // 2:] = 1, 2
    if b > 1:
        seg[1, s // 4:] = 1
    return seg


@pytest.mark.parametrize("b,s,h,h_kv,d,causal,with_seg", FLASH_CASES)
def test_flash_attention_bwd_matches_pallas(b, s, h, h_kv, d, causal,
                                            with_seg):
    rng = np.random.default_rng(b * s + h + d + causal)
    q, do = _rand(rng, b, s, h, d), _rand(rng, b, s, h, d)
    k, v = _rand(rng, b, s, h_kv, d), _rand(rng, b, s, h_kv, d)
    seg = _segments(b, s) if with_seg else None
    jseg = None if seg is None else jnp.asarray(seg)
    out_j, lse_j = flash_attention_pallas.flash_attention_forward_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        interpret=True, segment_ids=jseg)
    want = flash_attention_pallas.flash_attention_backward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), out_j, lse_j,
        jnp.asarray(do), causal=causal, interpret=True, segment_ids=jseg)
    tseg = None if seg is None else torch.from_numpy(seg)
    out, lse = flash_attention.flash_attention(
        _t(q), _t(k), _t(v), causal, tseg, with_lse=True)
    _close(out, out_j, FLASH_TOL)
    _close(lse, lse_j, FLASH_TOL)
    got = flash_attention.flash_attention_bwd(
        _t(q), _t(k), _t(v), _t(np.asarray(out_j)),
        _t(np.asarray(lse_j)), _t(do), causal, tseg)
    for a, b_ in zip(got, want):
        _close(a, b_, FLASH_TOL)


@pytest.mark.parametrize("causal,with_seg", [(True, False), (False, True)])
def test_flash_attention_function_matches_autograd_of_plain(causal,
                                                            with_seg):
    rng = np.random.default_rng(7)
    b, s, h, h_kv, d = 2, 32, 4, 2, 64
    q, do = _rand(rng, b, s, h, d), _rand(rng, b, s, h, d)
    k, v = _rand(rng, b, s, h_kv, d), _rand(rng, b, s, h_kv, d)
    seg = torch.from_numpy(_segments(b, s)) if with_seg else None

    def run(fn):
        ins = [_t(q, True), _t(k, True), _t(v, True)]
        return torch.autograd.grad(fn(*ins), ins, _t(do))

    got = run(lambda a, b_, c: flash_attention.FlashAttentionFunction.apply(
        a, b_, c, causal, seg, False))
    want = run(lambda a, b_, c: flash_attention.flash_attention_plain(
        a, b_, c, causal, seg))
    for a, b_ in zip(got, want):
        _close(a, b_.numpy(), FLASH_TOL)


def test_flash_attention_bwd_rejects_bad_inputs():
    q = torch.zeros(1, 8, 2, 64)
    lse = torch.zeros(2, 8)
    with pytest.raises(ValueError):                   # lse of the wrong shape
        flash_attention.flash_attention_bwd(q, q, q, q, lse[:1], q)
    with pytest.raises(ValueError):                   # dO of another shape
        flash_attention.flash_attention_bwd(q, q, q, q, lse, q[:, :4])
    with pytest.raises(ValueError):
        m = q.to("meta")
        flash_attention.flash_attention_bwd(m, m, m, m, lse.to("meta"), m)


# -- adamw ----------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(37, 130), (64, 128)])
@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("low", [False, True])
def test_adamw_matches_pallas_over_three_steps(shape, wd, low):
    """Three steps at step counts 1-3 with the learning rate changed
    between steps; ``low``: a bf16 parameter written from an f32 master,
    else an f32 parameter updated in place."""
    rng = np.random.default_rng(shape[0] + int(wd * 100) + low)
    w0 = _rand(rng, *shape)
    hyper = dict(beta1=0.9, beta2=0.95, eps=1e-8, wd=wd)
    jw, jm, jv = (jnp.asarray(w0), jnp.zeros(shape, jnp.float32),
                  jnp.zeros(shape, jnp.float32))
    master = torch.tensor(w0) if low else None
    param = torch.tensor(w0).to(torch.bfloat16) if low else torch.tensor(w0)
    m, v = torch.zeros(shape), torch.zeros(shape)
    for step, lr in enumerate((1e-3, 5e-4, 2e-3), start=1):
        g = _rand(rng, *shape)
        jw, jm, jv, jp = adamw_pallas.adamw_update(
            jw, jnp.asarray(g), jm, jv, lr, step,
            out_dtype=jnp.bfloat16 if low else jnp.float32, interpret=True,
            **hyper)
        scalars = adamw.adamw_scalars(torch.tensor(lr),
                                      torch.tensor(float(step)),
                                      hyper["beta1"], hyper["beta2"])
        adamw.adamw_update(param, torch.tensor(g), m, v, scalars,
                           master=master, **hyper)
        _close(m, jm)
        _close(v, jv)
        _close(master if low else param, jw)
        if low:
            np.testing.assert_allclose(
                param.float().numpy(),
                np.asarray(jp.astype(jnp.float32)), rtol=2.0 ** -8, atol=0)


def test_adamw_rejects_bad_inputs():
    p = torch.zeros(4)
    s = adamw.adamw_scalars(torch.tensor(1e-3), torch.tensor(1.0), 0.9, 0.99)
    kw = dict(beta1=0.9, beta2=0.99, eps=1e-8, wd=0.0)
    with pytest.raises(TypeError):                   # moments must be f32
        adamw.adamw_update(p, p, p.double(), p, s, **kw)
    with pytest.raises(ValueError):
        adamw.adamw_update(p, torch.zeros(5), p, p, s, **kw)
    with pytest.raises(ValueError):
        m = p.to("meta")
        adamw.adamw_update(m, m, m, m, s.to("meta"), **kw)
