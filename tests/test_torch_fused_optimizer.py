"""paddle_tpu_torch's fused optimizer step (``optimizer/fused.py``) and
``Optimizer.minimize``, on the CPU.

On the CPU ``fuse=True`` runs the fused step's bookkeeping (warm-up,
structure key, stats) over the eager loop, so it must give the eager
step's bits for each optimizer that takes ``fuse`` (all but LBFGS, which
steps through its closure and takes no ``fuse``, as in JAX), with and
without a global-norm clip and bf16 parameters with master weights. The
CUDA graph itself runs on the card only (``tests/test_torch_cuda.py``).
One case holds the port's fused AdamW against JAX's fused AdamW over three
steps (f32 ``rtol``/``atol`` 2e-4, the JAX tests' tolerance).
"""

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm, ClipGradByValue
from paddle_tpu_torch.optimizer import (LBFGS, SGD, Adadelta, Adagrad, Adam,
                                        Adamax, AdamW, Lamb, Momentum,
                                        RMSProp)
from paddle_tpu_torch.optimizer import fused
from paddle_tpu_torch.regularizer import L2Decay

TOL = dict(rtol=2e-4, atol=2e-4)
SHAPES = [(6, 12), (12,), (12, 3), (3,)]
#: every optimizer with ``fuse``: (class, keywords)
CASES = {
    "SGD": (SGD, dict(learning_rate=0.1)),
    "Momentum": (Momentum, dict(learning_rate=0.1, momentum=0.9,
                                use_nesterov=True)),
    "Adam": (Adam, dict(learning_rate=0.01, weight_decay=L2Decay(0.01))),
    "AdamW": (AdamW, dict(learning_rate=0.01, weight_decay=0.05)),
    "Adagrad": (Adagrad, dict(learning_rate=0.1)),
    "Adadelta": (Adadelta, dict(learning_rate=1.0)),
    "Adamax": (Adamax, dict(learning_rate=0.01)),
    "RMSProp": (RMSProp, dict(learning_rate=0.01, momentum=0.5,
                              centered=True)),
    "Lamb": (Lamb, dict(learning_rate=0.01, lamb_weight_decay=0.02,
                        exclude_from_weight_decay_fn=lambda p: p.ndim == 1)),
}


def _params(dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.nn.Parameter(torch.randn(*s, generator=g).to(dtype))
            for s in SHAPES]


def _grads(i, params):
    g = torch.Generator().manual_seed(1000 + i)
    return [torch.randn(p.shape, generator=g).to(p.dtype) for p in params]


def _state(opt, params):
    out = [p.detach().float().clone() for p in params]
    for name in sorted(opt._accumulators):
        out += [opt._accumulators[name][id(p)].clone() for p in params
                if id(p) in opt._accumulators[name]]
    out += [opt._master_weights[id(p)].clone() for p in params
            if id(p) in opt._master_weights]
    return out + [opt._step_tensor.clone()]


def _run(name, fuse, steps=3, clip=None, master=False, zero=False):
    cls, kw = CASES[name]
    params = _params(torch.bfloat16 if master else torch.float32)
    extra = dict(multi_precision=True) if master else {}
    opt = cls(parameters=params, fuse=fuse, grad_clip=clip, **kw, **extra)
    for i in range(steps):
        for p, g in zip(params, _grads(i, params)):
            if zero and p.grad is not None:
                p.grad.copy_(g)
            else:
                p.grad = g
        opt.step()
        opt.clear_grad(set_to_zero=zero)
    return opt, params


@pytest.mark.parametrize("master", [False, True], ids=["f32", "bf16-master"])
@pytest.mark.parametrize("clip", [None, "global"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_gives_the_eager_bits(name, clip, master):
    """Three steps with ``fuse=True`` against ``fuse=False``: every
    parameter, accumulator, master weight and the step counter the same
    bits; one warm-up (none for SGD without master weights: it has no
    state to make), then fused steps of one captured structure."""
    mk = (lambda: ClipGradByGlobalNorm(0.5)) if clip else (lambda: None)
    fo, fp = _run(name, True, clip=mk(), master=master)
    eo, ep = _run(name, False, clip=mk(), master=master)
    for a, b in zip(_state(fo, fp), _state(eo, ep)):
        assert torch.equal(a, b)
    warm = 0 if name == "SGD" and not master else 1
    assert fo._fused_impl.stats == {"fused": 3 - warm, "warmup": warm,
                                    "captures": 1, "fallbacks": 0}
    assert fo._step_count == eo._step_count == 3
    assert eo._fused_impl is None


def test_fuse_none_stays_eager():
    opt, _ = _run("AdamW", None)
    assert opt._fused_impl is None and opt._step_count == 3


def test_grads_at_new_addresses_and_zeroed_in_place():
    """``clear_grad()`` (new grad tensors every step) and
    ``clear_grad(set_to_zero=True)`` (the same tensors) give the same
    bits."""
    a, pa = _run("AdamW", True, steps=4, clip=ClipGradByGlobalNorm(0.5))
    b, pb = _run("AdamW", True, steps=4, clip=ClipGradByGlobalNorm(0.5),
                 zero=True)
    for x, y in zip(_state(a, pa), _state(b, pb)):
        assert torch.equal(x, y)


def _stepper(opt, params, start=0):
    i = [start]

    def step(which=None):
        for k, (p, g) in enumerate(zip(params, _grads(i[0], params))):
            p.grad = g if which is None or k in which else None
        opt.step()
        i[0] += 1
    return step


def test_structure_key_changes_and_invalidation():
    """A parameter that gains a grad (new state: a warm-up, then a new
    capture), one that loses it, a swapped clip and a new weight decay each
    give a new structure; ``set_lr`` and the same structure again do not;
    ``invalidate()`` drops every structure."""
    params = _params()
    opt = AdamW(0.01, parameters=params, weight_decay=0.05, fuse=True,
                grad_clip=ClipGradByGlobalNorm(1.0))
    stats = lambda: dict(opt._fused_impl.stats)  # noqa: E731
    step = _stepper(opt, params)
    step({0, 1, 2})
    step({0, 1, 2})
    assert stats() == {"fused": 1, "warmup": 1, "captures": 1,
                       "fallbacks": 0}
    opt.set_lr(0.005)
    step({0, 1, 2})
    assert stats()["captures"] == 1
    step()                                 # param 3 gains a grad: no state
    assert stats()["warmup"] == 2 and stats()["captures"] == 1
    step()
    assert stats()["captures"] == 2
    step({0, 1, 3})                        # param 2 loses it: a structure
    assert stats()["captures"] == 3 and stats()["warmup"] == 2
    step({0, 1, 2})                        # the first one again: cached
    assert stats()["captures"] == 3
    opt._grad_clip = ClipGradByValue(0.3)
    step({0, 1, 2})
    assert stats()["captures"] == 4
    opt._weight_decay = 0.1
    step({0, 1, 2})
    assert stats()["captures"] == 5
    opt._fused_impl.invalidate()
    step({0, 1, 2})
    assert stats() == {"fused": 8, "warmup": 2, "captures": 6,
                       "fallbacks": 0}


def test_restored_state_fuses_at_once():
    """``set_state_dict`` into a fresh optimizer makes every accumulator:
    its first fused step captures with no warm-up, and the resumed run
    gives the uninterrupted run's bits."""
    ref, rp = _run("Lamb", True, steps=4)
    params = _params()
    first = Lamb(parameters=params, fuse=True, **CASES["Lamb"][1])
    _stepper(first, params)({0, 1, 2, 3})
    _stepper(first, params, 1)()
    resumed = Lamb(parameters=params, fuse=True, **CASES["Lamb"][1])
    resumed.set_state_dict(first.state_dict())
    step = _stepper(resumed, params, 2)
    step()
    assert resumed._fused_impl.stats["warmup"] == 0
    step()
    for a, b in zip(_state(resumed, params), _state(ref, rp)):
        assert torch.equal(a, b)


def test_failed_capture_warns_counts_and_runs_eagerly(monkeypatch):
    """A capture that raises warns with its cause, counts a fallback, and
    that structure runs eagerly from then on (the eager bits)."""
    def broken(self, params_grads):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")
    monkeypatch.setattr(fused.FusedOptimizerStep, "_graphable",
                        staticmethod(lambda pg: True))
    monkeypatch.setattr(fused.FusedOptimizerStep, "_graph", broken)
    with pytest.warns(RuntimeWarning, match="capturing the update failed"):
        fo, fp = _run("Momentum", True, steps=4)
    eo, ep = _run("Momentum", False, steps=4)
    for a, b in zip(_state(fo, fp), _state(eo, ep)):
        assert torch.equal(a, b)
    assert fo._fused_impl.stats == {"fused": 0, "warmup": 1, "captures": 1,
                                    "fallbacks": 1}


def test_minimize_returns_the_params_and_grads():
    """``minimize(loss)``: backward, one step, ``(None, [(p, p.grad)])``
    over the parameter list (a param without a grad included); the
    static-graph branch raises."""
    params = _params()
    spare = torch.nn.Parameter(torch.ones(2))
    opt = SGD(0.1, parameters=params + [spare], fuse=True)
    before = [p.detach().clone() for p in params]
    loss = sum((p * p).sum() for p in params)
    out, pairs = opt.minimize(loss)
    assert out is None and [p for p, _ in pairs] == params + [spare]
    assert pairs[-1][1] is None
    for (p, g), b in zip(pairs[:-1], before):
        torch.testing.assert_close(g, 2 * b)
        torch.testing.assert_close(p.detach(), b - 0.1 * 2 * b)
    with pytest.raises(NotImplementedError, match="static"):
        opt.minimize(sum((p * p).sum() for p in params),
                     startup_program=object())


def test_lbfgs_takes_no_fuse():
    with pytest.raises(TypeError):
        LBFGS(parameters=_params(), fuse=True)


def test_fused_adamw_matches_jax_fused_adamw():
    """The port's fused AdamW against JAX's (``fuse=True``: its first step
    eager, then one jitted program), three steps of the same grads."""
    paddle.seed(0)
    jm = jnn.Sequential(jnn.Linear(6, 12), jnn.GELU(), jnn.Linear(12, 3))
    jparams = jm.parameters()
    tparams = [torch.nn.Parameter(torch.from_numpy(
        np.asarray(p.numpy()).copy())) for p in jparams]
    jopt = JaxAdamW(learning_rate=0.01, weight_decay=0.05,
                    parameters=jparams, fuse=True)
    topt = AdamW(0.01, parameters=tparams, weight_decay=0.05, fuse=True)
    for i in range(3):
        gs = _grads(i, tparams)
        for p, g in zip(jparams, gs):
            p.grad = paddle.to_tensor(g.numpy())
        for p, g in zip(tparams, gs):
            p.grad = g
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jopt.step()
        topt.step()
        jopt.clear_grad()
        topt.clear_grad()
    assert jopt._fused_impl.dispatches == 2
    assert topt._fused_impl.stats["fused"] == 2
    for jp, tp in zip(jparams, tparams):
        np.testing.assert_allclose(tp.detach().numpy(),
                                   np.asarray(jp.numpy()), **TOL)
        for name in ("moment1", "moment2"):
            np.testing.assert_allclose(
                topt._accumulators[name][id(tp)].numpy(),
                np.asarray(jopt._accumulators[name][id(jp)].numpy()), **TOL)
