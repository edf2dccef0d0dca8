"""paddle_tpu_torch optimizers against the JAX package's
``paddle_tpu/optimizer/optimizers.py``, on the CPU.

The same weights (made with numpy from a seed) take 5 steps in both
packages, each step's gradient that of ``sum(w * G_t) + 0.05 * sum(w**2)``
for a fresh seeded ``G_t``. The JAX side runs with its Pallas kernels in
interpret mode, so its Lamb sends the parameter of 8192 elements or more
through ``lamb_pallas._lamb_call`` and the smaller ones through its plain
path; the port runs every parameter through its kernels' plain versions.
Weights and every accumulator agree within 1e-5 relative (the same f32
arithmetic; the port multiplies by Adam's and Lamb's inverse bias
corrections where the JAX plain paths divide, and sums Lamb's norms in
another order). With ``multi_precision`` on bf16 parameters the f32
master weights are held to 1e-5 and the bf16 parameters to one bf16 ulp.
A JAX optimizer's ``state_dict()`` taken after 2 steps, as numpy arrays,
loaded into a port optimizer over the JAX weights of that moment, resumes
to the JAX run's weights after 5.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.regularizer as jreg
from paddle_tpu.ops.kernels import _common as jax_kern
from paddle_tpu.ops.kernels import lamb_pallas
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.nn import clip as tclip
from paddle_tpu_torch.ops.kernels import WRAPPERS

TOL = dict(rtol=1e-5, atol=1e-6)
SHAPES = ((96, 100), (24, 40), (40,))    # 9600 elements: Lamb's kernel path
STEPS = 5


class _Both:
    """One object per package: the optimizer module, the regularizer
    module, the clip module and the lr module."""

    def __init__(self, opt, reg, clip, lr):
        self.opt, self.reg, self.clip, self.lr = opt, reg, clip, lr


JAX = _Both(paddle.optimizer, jreg, paddle.nn, paddle.optimizer.lr)
PORT = _Both(topt, treg, tclip, topt.lr)

#: name -> (optimizer class name, a function of _Both giving its kwargs);
#: a scheduler given as the learning rate is stepped after each step
CASES = {
    "sgd": ("SGD", lambda b: dict(learning_rate=0.1)),
    "sgd_l2_value_clip": ("SGD", lambda b: dict(
        learning_rate=0.1, weight_decay=b.reg.L2Decay(0.02),
        grad_clip=b.clip.ClipGradByValue(0.5))),
    "sgd_float_decay_scheduler": ("SGD", lambda b: dict(
        learning_rate=b.lr.StepDecay(0.1, step_size=2, gamma=0.5),
        weight_decay=0.01)),
    "momentum": ("Momentum", lambda b: dict(learning_rate=0.05,
                                            momentum=0.9)),
    "momentum_nesterov_norm_clip": ("Momentum", lambda b: dict(
        learning_rate=0.05, momentum=0.8, use_nesterov=True,
        grad_clip=b.clip.ClipGradByNorm(2.0))),
    "momentum_l1": ("Momentum", lambda b: dict(
        learning_rate=0.05, weight_decay=b.reg.L1Decay(0.01))),
    "adagrad": ("Adagrad", lambda b: dict(learning_rate=0.1,
                                          initial_accumulator_value=0.1)),
    "adadelta": ("Adadelta", lambda b: dict(learning_rate=1.0, rho=0.9)),
    "adamax": ("Adamax", lambda b: dict(learning_rate=0.02)),
    "adamax_scheduler": ("Adamax", lambda b: dict(
        learning_rate=b.lr.CosineAnnealingDecay(0.02, T_max=4))),
    "rmsprop": ("RMSProp", lambda b: dict(learning_rate=0.01)),
    "rmsprop_centered_momentum": ("RMSProp", lambda b: dict(
        learning_rate=0.01, centered=True, momentum=0.9,
        weight_decay=b.reg.L2Decay(0.01))),
    "adam_l1": ("Adam", lambda b: dict(learning_rate=0.01,
                                       weight_decay=b.reg.L1Decay(1e-3))),
    "adamw_scheduler_global_clip": ("AdamW", lambda b: dict(
        learning_rate=b.lr.LinearWarmup(0.01, warmup_steps=2, start_lr=0.0,
                                        end_lr=0.01),
        grad_clip=b.clip.ClipGradByGlobalNorm(1.0))),
    "lamb": ("Lamb", lambda b: dict(learning_rate=0.01)),
    "lamb_schedule_exclude_clip": ("Lamb", lambda b: dict(
        learning_rate=b.lr.LinearWarmup(
            b.lr.CosineAnnealingDecay(2e-2, T_max=8), warmup_steps=2,
            start_lr=0.0, end_lr=2e-2),
        lamb_weight_decay=0.05,
        exclude_from_weight_decay_fn=lambda p: p.ndim == 1,
        grad_clip=b.clip.ClipGradByGlobalNorm(1.0))),
}
#: cases that also run on bf16 parameters with f32 master weights
MASTER_CASES = ("sgd", "momentum_nesterov_norm_clip", "adam_l1", "lamb")


@pytest.fixture(autouse=True)
def _interpret():
    """The JAX Pallas kernels in interpret mode; no port launch counted."""
    jax_kern.force_interpret(True)
    for w in WRAPPERS.values():
        w.launches = 0
    try:
        yield
    finally:
        jax_kern.force_interpret(False)
    assert all(w.launches == 0 for w in WRAPPERS.values())


def _init(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) * 0.5 for s in SHAPES]


def _grad_seed(step):
    rng = np.random.default_rng(100 + step)
    return [rng.standard_normal(s).astype(np.float32) for s in SHAPES]


def _jax_params(weights, dtype="float32"):
    out = []
    for w in weights:
        p = paddle.create_parameter(list(w.shape), dtype)
        p.set_value(paddle.to_tensor(w).astype(dtype))
        out.append(p)
    return out


def _port_params(weights, dtype=torch.float32):
    return [torch.nn.Parameter(torch.from_numpy(w.copy()).to(dtype))
            for w in weights]


def _named(jparams, tparams):
    """The port's parameters under the JAX parameters' names, which key
    both optimizers' state."""
    return [(j.name, t) for j, t in zip(jparams, tparams)]


def _jax_step(opt, params, gs, sched):
    loss = None
    for p, g in zip(params, gs):
        term = paddle.sum(p.astype("float32") * paddle.to_tensor(g)) + \
            0.05 * paddle.sum(paddle.square(p.astype("float32")))
        loss = term if loss is None else loss + term
    loss.backward()
    opt.step()
    opt.clear_grad()
    if sched is not None:
        sched.step()


def _port_step(opt, params, gs, sched):
    loss = sum((p.float() * torch.from_numpy(g)).sum()
               + 0.05 * p.float().square().sum() for p, g in zip(params, gs))
    loss.backward()
    opt.step()
    opt.clear_grad()
    if sched is not None:
        sched.step()


def _make(b, case, params, **extra):
    cls, kw = CASES[case]
    kw = kw(b)
    if b is JAX and cls != "LBFGS":
        kw["fuse"] = False
    sched = kw["learning_rate"] \
        if isinstance(kw["learning_rate"], b.lr.LRScheduler) else None
    return getattr(b.opt, cls)(parameters=params, **kw, **extra), sched


def _make_port(case, jparams, tparams, **extra):
    return _make(PORT, case, _named(jparams, tparams), **extra)


def _np_state(state):
    out = {}
    for k, v in state.items():
        if k == "master_weights":
            out[k] = {n: np.asarray(w.numpy()) for n, w in v.items()}
        elif k in ("LR_Scheduler", "@step"):
            out[k] = v
        else:
            out[k] = np.asarray(v.numpy())
    return out


def _check_state(tstate, jstate):
    jstate = _np_state(jstate)
    assert set(tstate) == set(jstate)
    for k, v in jstate.items():
        if k == "master_weights":
            for n, w in v.items():
                np.testing.assert_allclose(tstate[k][n].numpy(), w, **TOL,
                                           err_msg=n)
        elif k in ("LR_Scheduler", "@step"):
            assert tstate[k] == v, k
        else:
            np.testing.assert_allclose(tstate[k].numpy(), v, **TOL,
                                       err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_five_steps_match_jax(case, monkeypatch):
    """Five steps from the same weights: the weights and every
    accumulator (by the JAX key names) agree; JAX's Lamb reaches its
    Pallas kernel for the large parameter."""
    reached = []
    real = lamb_pallas._lamb_call
    monkeypatch.setattr(lamb_pallas, "_lamb_call",
                        lambda *a, **k: reached.append(1) or real(*a, **k))
    w0 = _init()
    jp = _jax_params(w0)
    tp = _port_params(w0)
    jopt, jsched = _make(JAX, case, jp)
    topt_, tsched = _make_port(case, jp, tp)
    for step in range(STEPS):
        gs = _grad_seed(step)
        _jax_step(jopt, jp, gs, jsched)
        _port_step(topt_, tp, gs, tsched)
        assert topt_.get_lr() == jopt.get_lr()
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), **TOL)
    _check_state(topt_.state_dict(), jopt.state_dict())
    assert bool(reached) == (CASES[case][0] == "Lamb")


@pytest.mark.parametrize("case", MASTER_CASES)
def test_master_weights_match_jax(case):
    """bf16 parameters with ``multi_precision=True``: f32 master weights
    within 1e-5, the bf16 parameters within one bf16 ulp of JAX's."""
    w0 = [w.astype(np.float32) for w in _init(3)]
    jp = _jax_params(w0, "bfloat16")
    tp = _port_params([np.asarray(p.astype("float32").numpy()) for p in jp],
                      torch.bfloat16)
    jopt, jsched = _make(JAX, case, jp, multi_precision=True)
    topt_, tsched = _make_port(case, jp, tp, multi_precision=True)
    for step in range(STEPS):
        gs = _grad_seed(step)
        _jax_step(jopt, jp, gs, jsched)
        _port_step(topt_, tp, gs, tsched)
    for a, b in zip(tp, jp):
        want = np.asarray(b.astype("float32").numpy())
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.detach().float().numpy(), want,
                                   rtol=2.0 ** -7, atol=1e-6)
    _check_state(topt_.state_dict(), jopt.state_dict())
    assert len(topt_.state_dict()["master_weights"]) == len(SHAPES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_state_dict_resumes(case):
    """Two JAX steps, then its state_dict (numpy arrays: every
    accumulator, ``@step`` and ``LR_Scheduler``) and weights into a fresh
    port optimizer; three more steps in each reach the same weights."""
    w0 = _init(1)
    jp = _jax_params(w0)
    jopt, jsched = _make(JAX, case, jp)
    for step in range(2):
        _jax_step(jopt, jp, _grad_seed(step), jsched)
    state = _np_state(jopt.state_dict())
    tp = _port_params([np.asarray(p.numpy()) for p in jp])
    topt_, tsched = _make_port(case, jp, tp)
    topt_.set_state_dict(state)
    assert topt_.get_lr() == jopt.get_lr()
    for step in range(2, STEPS):
        gs = _grad_seed(step)
        _jax_step(jopt, jp, gs, jsched)
        _port_step(topt_, tp, gs, tsched)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), **TOL)


@pytest.mark.parametrize("case", MASTER_CASES)
def test_jax_state_dict_with_master_weights_resumes(case):
    """bf16 parameters with master weights: two JAX steps, its state_dict
    (``master_weights`` among the entries) into a fresh port optimizer over
    the JAX bf16 weights; three more steps reach JAX's masters within 1e-5
    and its bf16 weights within one ulp."""
    w0 = _init(4)
    jp = _jax_params(w0, "bfloat16")
    jopt, jsched = _make(JAX, case, jp, multi_precision=True)
    for step in range(2):
        _jax_step(jopt, jp, _grad_seed(step), jsched)
    state = _np_state(jopt.state_dict())
    assert len(state["master_weights"]) == len(SHAPES)
    tp = _port_params([np.asarray(p.astype("float32").numpy()) for p in jp],
                      torch.bfloat16)
    topt_, tsched = _make_port(case, jp, tp, multi_precision=True)
    topt_.set_state_dict(state)
    for step in range(2, STEPS):
        gs = _grad_seed(step)
        _jax_step(jopt, jp, gs, jsched)
        _port_step(topt_, tp, gs, tsched)
    _check_state(topt_.state_dict(), jopt.state_dict())
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   np.asarray(b.astype("float32").numpy()),
                                   rtol=2.0 ** -7, atol=1e-6)


def test_lamb_per_parameter_learning_rate_matches_jax():
    """A parameter whose ``optimize_attr["learning_rate"]`` is 0.5 steps
    at half the rate in the port's Lamb as in JAX's."""
    w0 = _init(2)
    jp = _jax_params(w0)
    tp = _port_params(w0)
    jp[0].optimize_attr = tp[0].optimize_attr = {"learning_rate": 0.5}
    jopt, _ = _make(JAX, "lamb", jp)
    topt_, _ = _make_port("lamb", jp, tp)
    for step in range(3):
        gs = _grad_seed(step)
        _jax_step(jopt, jp, gs, None)
        _port_step(topt_, tp, gs, None)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), **TOL)


def _least_squares(seed=5):
    """A well-conditioned least-squares problem: A [30, 20] with singular
    values in [0.6, 1.2], b [30]."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((30, 20)))
    v, _ = np.linalg.qr(rng.standard_normal((20, 20)))
    a = (u * np.linspace(0.6, 1.2, 20)) @ v.T
    return a.astype(np.float32), rng.standard_normal(30).astype(np.float32)


def test_lbfgs_matches_jax():
    """LBFGS with a closure: the same losses and weights after two
    ``step`` calls of up to 4 iterations each, and the loss falls."""
    a, b = _least_squares()
    x0 = np.zeros(20, np.float32)
    jx = _jax_params([x0])[0]
    tx = _port_params([x0])[0]
    ja, jb = paddle.to_tensor(a), paddle.to_tensor(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    jopt = paddle.optimizer.LBFGS(learning_rate=1.0, max_iter=4,
                                  history_size=3, parameters=[jx])
    topt_ = topt.LBFGS(learning_rate=1.0, max_iter=4, history_size=3,
                       parameters=[tx])

    def jclosure():
        jopt.clear_grad()
        loss = 0.5 * paddle.sum(paddle.square(paddle.matmul(ja, jx) - jb))
        loss.backward()
        return loss

    def tclosure():
        topt_.clear_grad()
        loss = 0.5 * (ta @ tx - tb).square().sum()
        loss.backward()
        return loss

    losses = []
    for _ in range(2):
        jl = float(jopt.step(jclosure).numpy())
        tl = float(topt_.step(tclosure).detach())
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        losses.append(tl)
    np.testing.assert_allclose(tx.detach().numpy(), jx.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert losses[1] < losses[0] < 0.5 * float((b ** 2).sum())
    with pytest.raises(ValueError):
        topt_.step()


def test_learning_rate_type_and_unported_options():
    p = torch.nn.Parameter(torch.ones(3))
    with pytest.raises(TypeError):
        topt.SGD(learning_rate=lambda: 0.1, parameters=[p])
    # fuse=True and minimize's dygraph branch are ported (see
    # tests/test_torch_fused_optimizer.py); the static-graph branch is not
    assert topt.Lamb(parameters=[p], fuse=True)._fuse
    opt = topt.RMSProp(0.01, parameters=[p])
    with pytest.raises(NotImplementedError):
        opt.minimize(torch.zeros(()), startup_program=object())
    assert repr(treg.L1Decay(0.5)) == "L1Decay(0.5)"
    assert repr(treg.L2Decay(0.25)) == "L2Decay(0.25)"
