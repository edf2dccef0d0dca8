"""The incubate surface of paddle_tpu_torch against the JAX package's, on
the CPU: the public functions, the layers and the incubate path.

The JAX functions run under ``force_interpret(True)`` (restored in
``finally``), so they reach their Pallas kernels in interpret mode; the
port runs on the CPU, where every wrapper takes its plain version. Inputs
are made with numpy from a seed and handed to both. Tolerances, as the
largest absolute error over the largest reference magnitude: f32 1e-5 (the
same f32 arithmetic in another order), and 1e-4 for the two-layer path
(its attention products and layer norms compound the order of the sums
over two layers). Dropout with ``p > 0`` draws from the port's
generators, not ``jax.random``: there the keep share and the kept values
are checked, not JAX's mask. No kernel may launch on the CPU.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate as pinc
import paddle_tpu.incubate.nn as pinn
import paddle_tpu.incubate.nn.functional as PIF
import paddle_tpu.nn.functional as PF
from paddle_tpu.ops.kernels import _common as kern
import paddle_tpu_torch
from paddle_tpu_torch import incubate
from paddle_tpu_torch.incubate import nn as inn
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.models import incubate_from_jax_state
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.kernels import WRAPPERS

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    for w in WRAPPERS.values():
        w.launches = 0
    yield
    assert all(w.launches == 0 for w in WRAPPERS.values())


@pytest.fixture
def interpret():
    kern.force_interpret(True)
    try:
        yield
    finally:
        kern.force_interpret(False)


def _close(got, ref, tol=1e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got.numpy(), np.float32)
    ref = ref.detach().float().numpy() if isinstance(ref, torch.Tensor) \
        else np.asarray(ref.numpy(), np.float32)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    assert err <= tol * float(np.abs(ref).max()), err


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# -- the public functions at p = 0 and in eval ---------------------------------

@pytest.mark.parametrize("mask_shape", [(2, 1, 8, 16), (1, 1, 8, 16),
                                        (2, 1, 1, 16), None])
def test_softmax_mask_fuse_matches_jax(interpret, mask_shape):
    rng = np.random.default_rng(30)
    x = _rand(rng, 2, 3, 8, 16, scale=3.0)
    if mask_shape is None:
        want = pinc.softmax_mask_fuse_upper_triangle(paddle.to_tensor(x))
        got = incubate.softmax_mask_fuse_upper_triangle(torch.tensor(x))
    else:
        m = _rand(rng, *mask_shape)
        want = pinc.softmax_mask_fuse(paddle.to_tensor(x),
                                      paddle.to_tensor(m))
        got = incubate.softmax_mask_fuse(torch.tensor(x), torch.tensor(m))
    _close(got, want)


def test_softmax_mask_fuse_of_other_ranks_is_the_composite():
    rng = np.random.default_rng(31)
    x, m = _rand(rng, 3, 8, 16), _rand(rng, 8, 16)
    _close(incubate.softmax_mask_fuse(torch.tensor(x), torch.tensor(m)),
           pinc.softmax_mask_fuse(paddle.to_tensor(x), paddle.to_tensor(m)))
    _close(incubate.softmax_mask_fuse_upper_triangle(torch.tensor(x)),
           pinc.softmax_mask_fuse_upper_triangle(paddle.to_tensor(x)))


@pytest.mark.parametrize("training,rate", [(True, 0.0), (False, 0.5)])
@pytest.mark.parametrize("with_vecs", [True, False])
def test_fused_bias_dropout_residual_layer_norm_matches_jax(
        interpret, training, rate, with_vecs):
    rng = np.random.default_rng(32)
    x, res = _rand(rng, 2, 8, 32), _rand(rng, 2, 8, 32)
    vecs = [_rand(rng, 32, scale=0.1), 1.0 + _rand(rng, 32, scale=0.1),
            _rand(rng, 32, scale=0.1)] if with_vecs else [None] * 3
    kw = dict(dropout_rate=rate, ln_epsilon=1e-5, training=training)
    want = PIF.fused_bias_dropout_residual_layer_norm(
        paddle.to_tensor(x), paddle.to_tensor(res),
        *(None if v is None else paddle.to_tensor(v) for v in vecs), **kw)
    got = IF.fused_bias_dropout_residual_layer_norm(
        torch.tensor(x), torch.tensor(res),
        *(None if v is None else torch.tensor(v) for v in vecs), **kw)
    _close(got, want)


@pytest.mark.parametrize("training,p,mode", [
    (True, 0.0, "upscale_in_train"), (False, 0.3, "upscale_in_train"),
    (False, 0.3, "downscale_in_infer"), (True, 0.3, "upscale_in_train")])
def test_fused_dropout_add_matches_jax(interpret, training, p, mode):
    rng = np.random.default_rng(33)
    x, y = _rand(rng, 4, 300), _rand(rng, 4, 300)
    got = IF.fused_dropout_add(torch.tensor(x), torch.tensor(y), p=p,
                               training=training, mode=mode)
    if training and p:
        # other generators: the kept elements are x / (1 - p) + y, the
        # dropped ones y
        kept = np.isclose(got.numpy(), x / (1 - p) + y, rtol=1e-6,
                          atol=1e-6)
        dropped = got.numpy() == y
        assert (kept | dropped).all()
        assert 0.6 < kept.mean() < 0.8
        return
    want = PIF.fused_dropout_add(paddle.to_tensor(x), paddle.to_tensor(y),
                                 p=p, training=training, mode=mode)
    _close(got, want)


@pytest.mark.parametrize("multi_precision", [True, False])
@pytest.mark.parametrize("with_acc", [True, False])
@pytest.mark.parametrize("has_bias", [True, False])
def test_fused_linear_param_grad_add_matches_jax(interpret, multi_precision,
                                                 with_acc, has_bias):
    rng = np.random.default_rng(34)
    x, dy = _rand(rng, 4, 150, 64), _rand(rng, 4, 150, 48)
    jx = paddle.to_tensor(x).astype("bfloat16")
    jdy = paddle.to_tensor(dy).astype("bfloat16")
    tx = torch.tensor(x).to(torch.bfloat16)
    tdy = torch.tensor(dy).to(torch.bfloat16)
    acc, bacc = _rand(rng, 64, 48), _rand(rng, 48)
    jw = paddle.to_tensor(acc) if with_acc else None
    jb = paddle.to_tensor(bacc) if with_acc else None
    tw = torch.tensor(acc) if with_acc else None
    tb = torch.tensor(bacc) if with_acc else None
    want = PIF.fused_linear_param_grad_add(jx, jdy, jw, jb, multi_precision,
                                           has_bias)
    got = IF.fused_linear_param_grad_add(tx, tdy, tw, tb, multi_precision,
                                         has_bias)
    want_dt = torch.float32 if with_acc or multi_precision \
        else torch.bfloat16
    assert got[0].dtype == want_dt
    tol = 1e-5 if want_dt == torch.float32 else 2.0 ** -7
    _close(got[0], want[0], tol)
    if with_acc:
        assert got[0] is tw                  # updated in place
    if has_bias:
        _close(got[1], want[1], tol)
        if with_acc:
            assert got[1] is tb
    else:
        assert got[1] is None and want[1] is None


@pytest.mark.parametrize("activation", [None, "gelu", "relu"])
def test_fused_linear_family_matches_jax(activation):
    rng = np.random.default_rng(35)
    x, w, b = _rand(rng, 3, 5, 16), _rand(rng, 16, 24), _rand(rng, 24)
    jx, jw, jb = (paddle.to_tensor(a) for a in (x, w, b))
    tx, tw, tb = (torch.tensor(a) for a in (x, w, b))
    _close(IF.fused_linear_activation(tx, tw, tb, activation=activation),
           PIF.fused_linear_activation(jx, jw, jb, activation=activation))
    _close(IF.fused_linear(tx, tw.t().contiguous(), tb,
                           transpose_weight=True),
           PIF.fused_linear(jx, paddle.to_tensor(w.T.copy()), jb,
                            transpose_weight=True))
    _close(IF.fused_matmul_bias(tx, tx, transpose_y=True),
           PIF.fused_matmul_bias(jx, jx, transpose_y=True))


# -- p > 0: the port's own draws ------------------------------------------------

@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_draws_keep_share_and_values(p):
    paddle_tpu_torch.seed(5)
    mask = IF.dropout_mask((64, 1024), p, CPU)
    vals = set(mask.unique().tolist())
    assert vals <= {0.0, np.float32(1.0 / (1.0 - p))}
    share = (mask > 0).float().mean().item()
    assert abs(share - (1 - p)) < 0.01, share
    paddle_tpu_torch.seed(5)
    assert torch.equal(IF.dropout_mask((64, 1024), p, CPU), mask)
    assert not torch.equal(IF.dropout_mask((64, 1024), p, CPU), mask)
    x = torch.ones(64, 1024)
    out = F.dropout(x, p)
    assert set(out.unique().tolist()) <= {0.0, np.float32(1.0 / (1.0 - p))}
    assert abs((out > 0).float().mean().item() - (1 - p)) < 0.01
    ones = IF.fused_dropout_add(x, torch.zeros_like(x), p=p)
    assert abs((ones > 0).float().mean().item() - (1 - p)) < 0.01


def test_fused_bias_dropout_ln_at_p_one_and_training_masks():
    """p >= 1 in training drops everything: h is the residual alone; 0 < p
    < 1 gives another output than eval."""
    rng = np.random.default_rng(36)
    x, res = torch.tensor(_rand(rng, 4, 64)), torch.tensor(_rand(rng, 4, 64))
    full = IF.fused_bias_dropout_residual_layer_norm(x, res,
                                                     dropout_rate=1.0)
    _close(full, F.layer_norm(res, 64), 1e-5)
    train = IF.fused_bias_dropout_residual_layer_norm(x, res,
                                                      dropout_rate=0.5)
    ev = IF.fused_bias_dropout_residual_layer_norm(x, res, dropout_rate=0.5,
                                                   training=False)
    assert not torch.allclose(train, ev)


def test_rng_state_round_trip():
    paddle_tpu_torch.seed(11)
    state = paddle_tpu_torch.core.get_rng_state()
    a = IF.dropout_seed(), IF.dropout_mask((8, 8), 0.5, CPU)
    paddle_tpu_torch.core.set_rng_state(state)
    b = IF.dropout_seed(), IF.dropout_mask((8, 8), 0.5, CPU)
    assert a[0] == b[0] and torch.equal(a[1], b[1])
    assert 0 <= a[0] < 2 ** 31 - 1


# -- the layers, from the JAX layers' state dicts ------------------------------

def _state(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


@pytest.mark.parametrize("transpose_weight,bias_attr",
                         [(False, None), (True, None), (False, False)])
def test_fused_linear_layer_loads_jax_state(transpose_weight, bias_attr):
    paddle.seed(1)
    jl = pinn.FusedLinear(16, 24, bias_attr=bias_attr,
                          transpose_weight=transpose_weight)
    if bias_attr is None:
        jl.bias.set_value(paddle.to_tensor(
            np.random.default_rng(2).standard_normal(24).astype(np.float32)))
    tl = incubate_from_jax_state(
        inn.FusedLinear(16, 24, bias_attr=bias_attr,
                        transpose_weight=transpose_weight, device=CPU),
        _state(jl))
    x = _rand(np.random.default_rng(37), 2, 3, 16)
    _close(tl(torch.tensor(x)), jl(paddle.to_tensor(x)))
    with pytest.raises(KeyError):
        incubate_from_jax_state(inn.FusedLinear(16, 24, device=CPU),
                                {"weight": _state(jl)["weight"]}
                                if bias_attr is None else
                                {**_state(jl), "extra": np.zeros(1)})


def test_bias_dropout_ln_and_dropout_add_layers_load_jax_state(interpret):
    rng = np.random.default_rng(38)
    jl = pinn.FusedBiasDropoutResidualLayerNorm(32, dropout_rate=0.3)
    for name in ("linear_bias", "ln_scale", "ln_bias"):
        getattr(jl, name).set_value(paddle.to_tensor(_rand(rng, 32)))
    tl = incubate_from_jax_state(
        inn.FusedBiasDropoutResidualLayerNorm(32, dropout_rate=0.3,
                                              device=CPU), _state(jl))
    assert sorted(tl.state_dict()) == sorted(_state(jl))
    jl.eval()
    tl.eval()
    x, res = _rand(rng, 2, 5, 32), _rand(rng, 2, 5, 32)
    _close(tl(torch.tensor(x), torch.tensor(res)),
           jl(paddle.to_tensor(x), paddle.to_tensor(res)))
    jd, td = pinn.FusedDropoutAdd(0.3), inn.FusedDropoutAdd(0.3)
    assert _state(jd) == {} and incubate_from_jax_state(td, {}) is td
    jd.eval()
    td.eval()
    _close(td(torch.tensor(x), torch.tensor(res)),
           jd(paddle.to_tensor(x), paddle.to_tensor(res)))


# -- the incubate path ------------------------------------------------------------

HID, HEADS, SEQ, LAYERS, BATCH = 64, 4, 32, 2, 2


def _jax_block_layers():
    paddle.seed(3)
    layers = []
    for _ in range(LAYERS):
        mods = dict(qkv=pinn.FusedLinear(HID, 3 * HID),
                    out=pinn.FusedLinear(HID, HID, bias_attr=False),
                    ln1=pinn.FusedBiasDropoutResidualLayerNorm(HID, 0.0),
                    fc=pinn.FusedLinear(HID, 4 * HID),
                    proj=pinn.FusedLinear(4 * HID, HID),
                    add=pinn.FusedDropoutAdd(0.0))
        rng = np.random.default_rng(len(layers))
        for name in ("qkv", "fc", "proj"):
            b = mods[name].bias
            b.set_value(paddle.to_tensor(
                _rand(rng, *b.shape, scale=0.1)))
        for name in ("linear_bias", "ln_scale", "ln_bias"):
            p = getattr(mods["ln1"], name)
            p.set_value(paddle.to_tensor(
                _rand(rng, HID, scale=0.1) + (name == "ln_scale")))
        layers.append(mods)
    return layers


def _port_block_layers(jax_layers):
    out = []
    for jm in jax_layers:
        tm = dict(qkv=inn.FusedLinear(HID, 3 * HID, device=CPU),
                  out=inn.FusedLinear(HID, HID, bias_attr=False, device=CPU),
                  ln1=inn.FusedBiasDropoutResidualLayerNorm(HID, 0.0,
                                                            device=CPU),
                  fc=inn.FusedLinear(HID, 4 * HID, device=CPU),
                  proj=inn.FusedLinear(4 * HID, HID, device=CPU),
                  add=inn.FusedDropoutAdd(0.0))
        for name, mod in tm.items():
            incubate_from_jax_state(mod, _state(jm[name]))
            mod.requires_grad_(False)
        out.append(tm)
    return out


def _jax_path(layers, x_np):
    grads = {}

    def lin(name, mod, inp):
        out = mod(inp)

        def hook(g):
            mg = grads.get(name, (None, None))
            grads[name] = PIF.fused_linear_param_grad_add(
                inp, g, mg[0], mg[1], multi_precision=True,
                has_bias=mod.bias is not None)
        out.register_hook(hook)
        return out

    x = paddle.to_tensor(x_np, stop_gradient=False)
    h = x
    for i, m in enumerate(layers):
        qkv = lin(f"{i}.qkv", m["qkv"], h).reshape(
            [BATCH, SEQ, 3, HEADS, HID // HEADS])
        q, k, v = (qkv[:, :, j].transpose([0, 2, 1, 3]) for j in range(3))
        sc = paddle.matmul(q, k, transpose_y=True) / 4.0
        p = pinc.softmax_mask_fuse_upper_triangle(sc)
        o = paddle.matmul(p, v).transpose([0, 2, 1, 3]).reshape(
            [BATCH, SEQ, HID])
        o = lin(f"{i}.out", m["out"], o)
        h1 = m["ln1"](o, h)
        g = lin(f"{i}.proj", m["proj"], PF.gelu(lin(f"{i}.fc", m["fc"], h1)))
        h = m["add"](g, h1)
    loss = (h.astype("float32") ** 2).mean()
    loss.backward()
    return h, x.grad, grads


def _port_path(layers, x_np):
    grads = {}

    def lin(name, mod, inp):
        out = mod(inp)
        mg = grads.setdefault(name, [
            torch.zeros(mod.weight.shape),
            None if mod.bias is None else torch.zeros(mod.bias.shape)])

        def hook(g):
            IF.fused_linear_param_grad_add(inp, g, mg[0], mg[1],
                                           multi_precision=True,
                                           has_bias=mg[1] is not None)
        out.register_hook(hook)
        return out

    x = torch.tensor(x_np, requires_grad=True)
    h = x
    for i, m in enumerate(layers):
        qkv = lin(f"{i}.qkv", m["qkv"], h).reshape(
            BATCH, SEQ, 3, HEADS, HID // HEADS)
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
        sc = q @ k.transpose(-1, -2) / 4.0
        p = incubate.softmax_mask_fuse_upper_triangle(sc)
        o = (p @ v).transpose(1, 2).reshape(BATCH, SEQ, HID)
        o = lin(f"{i}.out", m["out"], o)
        h1 = m["ln1"](o, h)
        g = lin(f"{i}.proj", m["proj"], F.gelu(lin(f"{i}.fc", m["fc"], h1)))
        h = m["add"](g, h1)
    h.float().square().mean().backward()
    return h, x.grad, grads


def test_incubate_path_matches_jax(interpret):
    """The chip phase's post-LN block (hidden 64, 4 heads of 16, S 32, two
    layers, dropout 0), its linears' weight and bias gradients accumulated
    by ``fused_linear_param_grad_add`` from hooks on their outputs: the
    output, dx and every main_grad against the JAX package's public ops."""
    jl = _jax_block_layers()
    tl = _port_block_layers(jl)
    x = _rand(np.random.default_rng(39), BATCH, SEQ, HID)
    out_j, dx_j, grads_j = _jax_path(jl, x)
    out_t, dx_t, grads_t = _port_path(tl, x)
    _close(out_t, out_j, 1e-4)
    _close(dx_t, dx_j, 1e-4)
    assert sorted(grads_t) == sorted(grads_j) and len(grads_t) == 4 * LAYERS
    for name, (dw_j, db_j) in grads_j.items():
        dw_t, db_t = grads_t[name]
        _close(dw_t, dw_j, 1e-4)
        if db_j is None:
            assert db_t is None
        else:
            _close(db_t, db_j, 1e-4)
