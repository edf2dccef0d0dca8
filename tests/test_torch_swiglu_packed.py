"""paddle_tpu_torch packed SwiGLU (``nn.functional.swiglu(x)`` with one
``[.., 2I]`` operand) against the JAX package, on the CPU.

The same numpy inputs go through ``swiglu_pallas.swiglu_packed`` in
interpret mode (its forward kernel ``_fused_fwd_packed`` and, through
``jax.vjp``, its backward kernel ``_fused_bwd_packed``), through the JAX
composite ``paddle_tpu.ops.activation.swiglu`` (split, then
``silu(g) * u``), and through the port's ``swiglu(x)``, which runs the
plain versions on the CPU. Tolerance 1e-6 (f32, the same arithmetic); no
kernel may launch on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.ops.kernels import swiglu_pallas
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops.kernels import WRAPPERS, swiglu

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    for w in WRAPPERS.values():
        w.launches = 0
    yield
    assert all(w.launches == 0 for w in WRAPPERS.values())


@pytest.mark.parametrize("shape", [(4, 512), (2, 7, 256), (1, 3, 5, 128)])
def test_packed_swiglu_matches_jax(monkeypatch, shape):
    """Forward and gradient against the JAX packed kernel (both of its
    kernels must be reached) and the JAX composite."""
    reached = set()
    for name in ("_fused_fwd_packed", "_fused_bwd_packed"):
        def counted(*a, _fn=getattr(swiglu_pallas, name), _n=name, **kw):
            reached.add(_n)
            return _fn(*a, **kw)
        monkeypatch.setattr(swiglu_pallas, name, counted)
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    dy = rng.standard_normal(shape[:-1] + (shape[-1] // 2,)).astype(
        np.float32)
    y_k, vjp = jax.vjp(lambda a: swiglu_pallas.swiglu_packed(a, True),
                       jnp.asarray(x))
    (dx_k,) = vjp(jnp.asarray(dy))
    assert reached == {"_fused_fwd_packed", "_fused_bwd_packed"}
    y_c = paddle.swiglu(paddle.to_tensor(x)).numpy()

    xt = torch.tensor(x, requires_grad=True)
    y = TF.swiglu(xt)
    y.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_k), **TOL)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_c), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_k), **TOL)


def test_packed_equals_two_operand_swiglu():
    """The packed op is the two-operand op on the halves, forward and
    backward, and ``plain=True`` gives the same on the CPU."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 2 * 48)).astype(np.float32)
    dy = torch.from_numpy(rng.standard_normal((6, 48)).astype(np.float32))
    xt = torch.tensor(x, requires_grad=True)
    TF.swiglu(xt).backward(dy)
    g = torch.tensor(x[:, :48], requires_grad=True)
    u = torch.tensor(x[:, 48:], requires_grad=True)
    y2 = TF.swiglu(g, u)
    y2.backward(dy)
    torch.testing.assert_close(TF.swiglu(torch.from_numpy(x)), y2.detach())
    torch.testing.assert_close(xt.grad, torch.cat([g.grad, u.grad], -1))
    xp = torch.tensor(x, requires_grad=True)
    TF.swiglu(xp, plain=True).backward(dy)
    torch.testing.assert_close(xp.grad, xt.grad)


def test_packed_swiglu_rejects_what_it_does_not_take():
    with pytest.raises(ValueError, match=r"\[\.\.\., 2I\]"):
        swiglu.swiglu_packed(torch.zeros(3, 5))
    with pytest.raises(ValueError, match="does not fit"):
        swiglu.swiglu_packed_bwd(torch.zeros(3, 8), torch.zeros(3, 8))
    with pytest.raises(TypeError):
        swiglu.swiglu_packed(torch.zeros(3, 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="no kernel for device"):
        swiglu.swiglu_packed(torch.zeros(3, 32, device="meta"))
