"""The fused layers of paddle_tpu_torch's ``incubate.nn``
(``FusedMultiHeadAttention``, ``FusedFeedForward``,
``FusedTransformerEncoderLayer``, ``FusedEcMoe``), their functions
``fused_feedforward`` and ``fused_ec_moe``, and ``incubate_from_jax_state``
against the JAX package's, on the CPU: forward and gradients.

Each JAX layer is built with constant initializers (its random draws
compile for seconds on the CPU) and given seeded numpy weights; the port's
layer loads that layer's ``state_dict()`` arrays with no transposition.
The JAX results are computed once for the module (a fixture). Tolerance:
f32 ``atol``/``rtol`` 2e-4 (the JAX tests' own). Dropout rates are 0 in
the comparisons; the JAX attention is its SDPA composite, the port's the
flash kernel's plain version where there is no mask. No kernel may launch
on the CPU.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate.nn as pinn
import paddle_tpu.incubate.nn.functional as PIF
from paddle_tpu_torch.incubate import nn as inn
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.models import incubate_from_jax_state
from paddle_tpu_torch.ops.kernels import WRAPPERS

TOL = dict(atol=2e-4, rtol=2e-4)
E, H, FF, B, S = 32, 4, 64, 2, 8


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    for w in WRAPPERS.values():
        w.launches = 0
    yield
    assert not any(w.launches for w in WRAPPERS.values())


def _r(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t.numpy())


def _const_attrs(names):
    zero = paddle.ParamAttr(initializer=paddle.nn.initializer.Constant(0.0))
    return {n: zero for n in names}


_MHA_ATTRS = ("qkv_weight_attr", "qkv_bias_attr", "linear_weight_attr",
              "linear_bias_attr", "pre_ln_scale_attr", "pre_ln_bias_attr",
              "ln_scale_attr", "ln_bias_attr")
_FFN_ATTRS = ("linear1_weight_attr", "linear1_bias_attr",
              "linear2_weight_attr", "linear2_bias_attr", "ln1_scale_attr",
              "ln1_bias_attr", "ln2_scale_attr", "ln2_bias_attr")


def _seed_weights(layer, rng):
    """Seeded numpy weights into a JAX layer; returns its state as numpy."""
    state = {}
    for name, p in layer.state_dict().items():
        shape = tuple(p.shape)
        scale = 0.3 if len(shape) > 1 else 0.1
        arr = _r(rng, *shape, scale=scale)
        if name.endswith("scale"):
            arr = arr + 1.0
        state[name] = arr
    layer.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def _jax_encoder():
    """FusedTransformerEncoderLayer built without random draws (its two
    sublayers replaced by constant-initialised ones of the same config)."""
    enc = pinn.FusedTransformerEncoderLayer.__new__(
        pinn.FusedTransformerEncoderLayer)
    paddle.nn.Layer.__init__(enc)
    enc.fused_attn = pinn.FusedMultiHeadAttention(
        E, H, dropout_rate=0.0, attn_dropout_rate=0.0,
        **_const_attrs(_MHA_ATTRS))
    enc.ffn = pinn.FusedFeedForward(E, FF, dropout_rate=0.0,
                                    activation="gelu",
                                    **_const_attrs(_FFN_ATTRS))
    return enc


def _loss_jax(out, c):
    return ((out * paddle.to_tensor(c)) ** 2).mean()


def _loss_port(out, c):
    return (out * torch.from_numpy(c)).square().mean()


#: the encoder case holds the post-LN masked attention (its composite) and
#: a post-LN gelu FFN; "mha pre-LN" has no mask, so the port's attention is
#: the flash kernel's plain version there (JAX's gradients of it are not
#: taken: its backward compiles for seconds; the flash plain backward is
#: held to the composite's below)
CASES = ("mha pre-LN", "ffn pre-LN relu", "encoder post-LN gelu masked",
         "ec_moe gelu")


@pytest.fixture(scope="module")
def case():
    """Per case: the JAX layer's state (numpy), the input, the mask, and
    the JAX output and weight gradients."""
    rng = np.random.default_rng(2210)
    x = _r(rng, B, S, E)
    chan = _r(rng, E)
    mask = np.where(rng.uniform(size=(B, 1, S, S)) < 0.3, -1e4,
                    0.0).astype(np.float32)
    mask[..., 0] = 0.0
    layers = {
        "mha pre-LN": pinn.FusedMultiHeadAttention(
            E, H, dropout_rate=0.0, attn_dropout_rate=0.0,
            normalize_before=True, **_const_attrs(_MHA_ATTRS)),
        "ffn pre-LN relu": pinn.FusedFeedForward(
            E, FF, dropout_rate=0.0, normalize_before=True,
            **_const_attrs(_FFN_ATTRS)),
        "encoder post-LN gelu masked": _jax_encoder(),
        "ec_moe gelu": pinn.FusedEcMoe(E, FF, 4, act_type="gelu",
                                       **_const_attrs(("weight_attr",
                                                       "bias_attr"))),
    }
    out = {}
    for name, jl in layers.items():
        state = _seed_weights(jl, rng)
        m = mask if "masked" in name else None
        xt = paddle.to_tensor(x)
        if name.startswith("mha"):
            with paddle.no_grad():
                y, grads = jl(xt), None
        else:
            y = jl(xt, src_mask=paddle.to_tensor(m)) \
                if name.startswith("encoder") else jl(xt)
            _loss_jax(y, chan).backward()
            grads = {n: np.asarray(p.grad.numpy())
                     for n, p in jl.named_parameters() if p.grad is not None}
        out[name] = dict(state=state, y=_np(y), grads=grads, mask=m)
    return dict(x=x, chan=chan, layers=out)


def _port_layer(name):
    kw = dict(device="cpu")
    if name.startswith("mha"):
        return inn.FusedMultiHeadAttention(
            E, H, dropout_rate=0.0, attn_dropout_rate=0.0,
            normalize_before=True, **kw)
    if name.startswith("ffn"):
        return inn.FusedFeedForward(E, FF, dropout_rate=0.0,
                                    normalize_before=True, **kw)
    if name.startswith("encoder"):
        return inn.FusedTransformerEncoderLayer(
            E, H, FF, dropout_rate=0.0, attn_dropout_rate=0.0,
            activation="gelu", **kw)
    return inn.FusedEcMoe(E, FF, 4, act_type="gelu", **kw)


@pytest.mark.parametrize("name", CASES)
def test_layer_from_jax_state_matches_forward_and_gradients(case, name):
    ref = case["layers"][name]
    port = _port_layer(name)
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == \
        {k: v.shape for k, v in ref["state"].items()}
    incubate_from_jax_state(port, ref["state"])
    x = torch.from_numpy(case["x"])
    m = None if ref["mask"] is None else torch.from_numpy(ref["mask"])
    y = port(x, src_mask=m) if name.startswith("encoder") else port(x)
    np.testing.assert_allclose(_np(y), ref["y"], **TOL)
    _loss_port(y, case["chan"]).backward()
    got = {n: _np(p.grad) for n, p in port.named_parameters()
           if p.grad is not None}
    if ref["grads"] is None:            # the flash path: held to the composite
        port.zero_grad()
        _loss_port(port(x, attn_mask=torch.zeros(B, 1, S, S)),
                   case["chan"]).backward()
        ref = dict(ref, grads={n: _np(p.grad) for n, p in
                               port.named_parameters() if p.grad is not None})
    assert set(got) == set(ref["grads"])
    for n, g in got.items():
        np.testing.assert_allclose(g, ref["grads"][n], err_msg=n, **TOL)


def test_layers_default_to_the_card_and_draw_seeded_weights():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        inn.FusedFeedForward(E, FF)
    a = inn.FusedMultiHeadAttention(E, H, device="cpu", seed=5)
    b = inn.FusedMultiHeadAttention(E, H, device="cpu", seed=5)
    torch.testing.assert_close(a.qkv_weight, b.qkv_weight, atol=0, rtol=0)
    # JAX's Xavier fans of a [3, H, hd, E] weight: 4 * 8 * 32 and 3 * 8 * 32
    std = a.qkv_weight.std().item()
    assert abs(std - (2.0 / (4 * 8 * 32 + 3 * 8 * 32)) ** 0.5) < 0.01


def test_attention_layers_raise_like_jax():
    mha = inn.FusedMultiHeadAttention(E, H, device="cpu")
    x = torch.zeros(1, 4, E)
    with pytest.raises(NotImplementedError, match="self-attention"):
        mha(x, key=torch.zeros(1, 4, E))
    with pytest.raises(NotImplementedError, match="kv-cache"):
        mha(x, cache=object())
    with pytest.raises(ValueError, match="divisible"):
        inn.FusedMultiHeadAttention(30, 4, device="cpu")
    enc = inn.FusedTransformerEncoderLayer(E, H, FF, device="cpu")
    with pytest.raises(NotImplementedError, match="kv-cache"):
        enc(x, cache=object())
    with pytest.raises(ValueError, match="act_type"):
        inn.FusedEcMoe(E, FF, 4, act_type="silu", device="cpu")


def test_training_dropout_draws_from_the_default_generator():
    import paddle_tpu_torch
    ffn = inn.FusedFeedForward(E, FF, dropout_rate=0.5, device="cpu")
    x = torch.randn(B, S, E, generator=torch.Generator().manual_seed(0))
    outs = []
    for seed in (1, 1, 2):
        paddle_tpu_torch.seed(seed)
        outs.append(ffn(x))
    torch.testing.assert_close(outs[0], outs[1], atol=0, rtol=0)
    assert not torch.equal(outs[0], outs[2])
    ffn.eval()
    torch.testing.assert_close(ffn(x), ffn(x), atol=0, rtol=0)


# -- the functions ------------------------------------------------------------

def _fn_cases():
    rng = np.random.default_rng(2211)
    x = _r(rng, B, S, E)
    ffn = dict(linear1_bias=_r(rng, FF), linear2_bias=_r(rng, E),
               ln1_scale=_r(rng, E) + 1, ln1_bias=_r(rng, E),
               ln2_scale=_r(rng, E) + 1, ln2_bias=_r(rng, E),
               dropout1_rate=0.0, dropout2_rate=0.0)
    w1, w2 = _r(rng, E, FF, scale=0.3), _r(rng, FF, E, scale=0.3)
    moe = (x, _r(rng, B, S, 4), _r(rng, 4, E, FF, scale=0.3),
           _r(rng, 4, 1, FF), _r(rng, 4, FF, E, scale=0.3), _r(rng, 4, 1, E))
    return {
        "fused_feedforward pre-LN relu": (
            "fused_feedforward", (x, w1, w2),
            dict(pre_layer_norm=True, **ffn)),
        "fused_feedforward post-LN gelu": (
            "fused_feedforward", (x, w1, w2),
            dict(activation="gelu", **ffn)),
        "fused_ec_moe gelu": ("fused_ec_moe", moe + ("gelu",), {}),
        "fused_ec_moe relu": ("fused_ec_moe", moe + ("relu",), {}),
    }


FN_CASES = _fn_cases()


@pytest.fixture(scope="module")
def fn_refs():
    def conv(v):
        return paddle.to_tensor(v) if isinstance(v, np.ndarray) else v
    return {name: _np(getattr(PIF, fn)(*map(conv, args),
                                        **{k: conv(v) for k, v in kw.items()}))
            for name, (fn, args, kw) in FN_CASES.items()}


@pytest.mark.parametrize("name", list(FN_CASES))
def test_function_matches_jax(fn_refs, name):
    fn, args, kw = FN_CASES[name]

    def conv(v):
        return torch.from_numpy(v) if isinstance(v, np.ndarray) else v
    got = getattr(IF, fn)(*map(conv, args),
                          **{k: conv(v) for k, v in kw.items()})
    np.testing.assert_allclose(_np(got), fn_refs[name], **TOL)


def test_fused_ec_moe_is_expert_choice():
    """Against a loop over the experts: expert e takes the ``B*S // E``
    tokens of highest softmax score in its column, runs its MLP on them,
    scales each result by that score and adds it at its token; a token no
    expert takes comes back zero."""
    rng = np.random.default_rng(2212)
    b, s, e, cap = 2, 8, 4, 4
    x, gate = _r(rng, b, s, E), _r(rng, b, s, e, scale=2.0)
    w1, b1 = _r(rng, e, E, FF, scale=0.3), _r(rng, e, 1, FF)
    w2, b2 = _r(rng, e, FF, E, scale=0.3), _r(rng, e, 1, E)
    got = IF.fused_ec_moe(*map(torch.from_numpy, (x, gate, w1, b1, w2, b2)),
                          "relu")
    tokens = x.reshape(b * s, E)
    z = np.exp(gate.reshape(b * s, e) - gate.max(-1).reshape(-1, 1))
    scores = z / z.sum(-1, keepdims=True)
    want = np.zeros_like(tokens)
    for k in range(e):
        for t in np.argsort(-scores[:, k], kind="stable")[:cap]:
            hmid = np.maximum(tokens[t] @ w1[k] + b1[k, 0], 0.0)
            want[t] += (hmid @ w2[k] + b2[k, 0]) * scores[t, k]
    np.testing.assert_allclose(_np(got).reshape(b * s, E), want, **TOL)
    assert (np.abs(want).sum(-1) == 0).any()     # some token left out
    with pytest.raises(ValueError, match="act_type"):
        IF.fused_ec_moe(*map(torch.from_numpy, (x, gate, w1, b1, w2, b2)),
                        "silu")
