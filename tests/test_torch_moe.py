"""paddle_tpu_torch's ``MoELayer`` and gates against the JAX package's
``incubate/distributed/models/moe``, on the CPU.

The JAX layer is built from a seed (SwiGLU experts as Qwen2-MoE builds
them, or a Linear-GELU-Linear template) and its ``state_dict()`` is
carried into the port's layer (the router's and the shared expert's linear
weights transposed, the stacked experts as they are). Both run the same
numpy tokens at ``capacity_factor=0.5``, so every case drops routed slots
and the arrival order decides which. The JAX side runs its vmap path (what
a CPU takes) or, for SwiGLU experts, its grouped Pallas kernel in
interpret mode (``force_interpret(True)``). Tolerances: 1e-5 on the
output, ``l_aux`` and every gradient (the same f32 math; the combine adds
a token's terms in another order).
"""

import jax  # noqa: F401  (JAX on the CPU before the port's imports)
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.distributed.models import moe as jax_moe
from paddle_tpu.models.qwen2_moe import _SwiGLU as JaxSwiGLU
from paddle_tpu.ops.kernels import _common as jax_kern
from paddle_tpu_torch.incubate.distributed.models import moe
from paddle_tpu_torch.models.qwen2_moe import _SwiGLU
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.ops.kernels import WRAPPERS

TOL = dict(rtol=1e-5, atol=1e-5)
H, M, E = 32, 16, 4
GATES = {"gshard": {"type": "gshard", "top_k": 2},
         "switch": {"type": "switch"},
         "naive": {"type": "naive", "top_k": 2}}
TRANSPOSED = ("gate.gate.weight", "_proj.weight")


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    for w in WRAPPERS.values():
        w.launches = 0
    yield
    assert all(w.launches == 0 for w in WRAPPERS.values())


def _templates(lib, template, shared):
    nn = paddle.nn if lib is paddle else torch.nn
    if template == "swiglu":
        cls = JaxSwiGLU if lib is paddle else _SwiGLU
        experts = [cls(H, M, 0.3, 2) for _ in range(E)]
    else:
        experts = [nn.Sequential(nn.Linear(H, M), nn.GELU(), nn.Linear(M, H))
                   for _ in range(E)]
    if not shared:
        return experts, None
    return experts, (JaxSwiGLU if lib is paddle else _SwiGLU)(H, 2 * M, 0.3, 2)


def _pair(gate, shared, template="swiglu", seed=0, cf=0.5):
    paddle.seed(seed)
    experts, sh = _templates(paddle, template, shared)
    jl = jax_moe.MoELayer(d_model=H, experts=experts, gate=dict(GATES[gate]),
                          capacity_factor=cf, shared_experts=sh)
    experts, sh = _templates(torch, template, shared)
    tl = moe.MoELayer(d_model=H, experts=experts, gate=dict(GATES[gate]),
                      capacity_factor=cf, shared_experts=sh)
    state = {}
    for k, v in jl.state_dict().items():
        a = np.asarray(v.numpy())
        if k.endswith(TRANSPOSED):
            a = a.T
        state[k] = torch.from_numpy(np.array(a))
    tl.load_state_dict(state)
    return jl, tl


def _run_jax(jl, x, cot, coef):
    xt = paddle.to_tensor(x, stop_gradient=False)
    out = jl(xt)
    loss = (out * paddle.to_tensor(cot)).sum() + coef * jl.l_aux
    loss.backward()
    grads = {n: np.asarray(p.grad.numpy()) for n, p in jl.named_parameters()}
    return (np.asarray(out.numpy()), float(jl.l_aux.numpy()),
            np.asarray(xt.grad.numpy()), grads)


def _check(jl, tl, seed=1, coef=0.1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 8, H)).astype(np.float32)
    cot = rng.standard_normal((2, 8, H)).astype(np.float32)
    want, aux_j, dx_j, grads_j = _run_jax(jl, x, cot, coef)
    xt = torch.from_numpy(x).requires_grad_()
    out = tl(xt)
    ((out * torch.from_numpy(cot)).sum() + coef * tl.l_aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(tl.l_aux.item(), aux_j, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), dx_j, **TOL)
    got = dict(tl.named_parameters())
    assert set(got) == set(grads_j)
    for name, g in grads_j.items():
        if name.endswith(TRANSPOSED):
            g = g.T
        np.testing.assert_allclose(got[name].grad.numpy(), g, **TOL,
                                   err_msg=name)
    return tl


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "routed"])
@pytest.mark.parametrize("gate", list(GATES))
def test_moe_layer_matches_jax_vmap_path(gate, shared):
    """Out, ``l_aux`` and every gradient against the JAX layer's vmap path,
    for each gate, with and without a shared expert; capacity drops
    happen (n*k routed slots > E * capacity)."""
    jl, tl = _pair(gate, shared)
    tl = _check(jl, tl)
    k = tl.top_k
    assert k == (1 if gate == "switch" else 2)
    cap = max(int(np.ceil(0.5 * 16 * k / E)), 1)
    assert 16 * k > E * cap


@pytest.mark.parametrize("gate", ["gshard", "switch"])
def test_moe_layer_matches_jax_grouped_kernel(gate):
    """The JAX layer through its grouped Pallas kernel (interpret mode),
    which the port's SwiGLU experts always take."""
    jax_kern.force_interpret(True)
    try:
        jl, tl = _pair(gate, True, seed=3)
        _check(jl, tl, seed=4)
    finally:
        jax_kern.force_interpret(False)


def test_non_swiglu_expert_template_matches_jax():
    """A Linear-GELU-Linear template runs once per expert through
    ``functional_call``; its stacked linear weights keep JAX's
    ``[E, in, out]``."""
    jl, tl = _pair("gshard", False, template="gelu", seed=5)
    assert not tl._ffn_fast
    assert tuple(tl.expert_0.shape) == (E, H, M)
    assert tuple(tl.expert_1.shape) == (E, M)
    _check(jl, tl, seed=6)


def test_arrival_order_is_token_major():
    """Two experts, top-2, three tokens, capacity 2. Tokens 0 and 2 choose
    expert 0 first, token 1 expert 1. Token-major arrival (0a 0b 1a 1b 2a
    2b) fills both queues with tokens 0 and 1 and drops token 2 from both;
    an order by choice rank (0a 1a 2a 0b 1b 2b) would keep token 2's first
    choice."""
    torch.manual_seed(0)
    tl = moe.MoELayer(d_model=4, experts=[_SwiGLU(4, 8) for _ in range(2)],
                      gate={"type": "naive", "top_k": 2},
                      capacity_factor=0.5)
    with torch.no_grad():
        tl.gate.gate.weight.copy_(torch.tensor([[1.0, 0, 0, 0],
                                                [-1.0, 0, 0, 0]]))
        tl.gate.gate.bias.zero_()
        x = torch.randn(3, 4)
        x[:, 0] = torch.tensor([1.0, -1.0, 1.0])
        out = tl(x)
    assert torch.equal(out[2], torch.zeros(4))
    assert (out[:2].abs().sum(-1) > 0).all()


def test_gates_and_options():
    g = moe.NaiveGate(256, 64)
    assert tuple(g.gate.weight.shape) == (64, 256)
    assert g.gate.bias.abs().max() == 0
    std = g.gate.weight.std().item()
    assert abs(std - np.sqrt(2.0 / (256 + 64))) < 0.05 * std
    assert moe.SwitchGate(8, 4, top_k=3).top_k == 1
    assert moe.GShardGate(8, 4).top_k == 2
    assert isinstance(moe.GShardGate(8, 4), moe.BaseGate)
    experts = [_SwiGLU(8, 8) for _ in range(2)]
    with pytest.raises(NotImplementedError, match="mesh"):
        moe.MoELayer(8, experts, moe_group="dp")
    with pytest.raises(NotImplementedError, match="mesh"):
        moe.MoELayer(8, experts, mp_group="mp")
    layer = moe.MoELayer(8, experts, expert_parallel_axis="ep")
    assert layer.gate.world_size == 1 and layer.num_expert == 2
    for name in ("MoELayer", "NaiveGate", "GShardGate", "SwitchGate",
                 "BaseGate", "ClipGradForMOEByGlobalNorm"):
        assert hasattr(jax_moe, name) and name in moe.__all__


def test_moe_clip_is_the_global_norm():
    """``ClipGradForMOEByGlobalNorm`` scales as ``ClipGradByGlobalNorm``
    does: every expert's gradient lives in one stacked parameter."""
    rng = np.random.default_rng(7)
    pg = [(torch.zeros(1), torch.from_numpy(
        rng.standard_normal(s).astype(np.float32))) for s in
        [(4, 8, 16), (16,), (3, 3)]]
    clip = moe.ClipGradForMOEByGlobalNorm(1.0, is_expert_param_func=None)
    got = clip(pg)
    want = ClipGradByGlobalNorm(1.0)(pg)
    for (_, a), (_, b) in zip(got, want):
        assert torch.equal(a, b)
    assert clip.last_global_norm.item() > 1.0
    assert clip.moe_group is None
