"""paddle_tpu_torch learning-rate schedulers against the JAX package's
``paddle_tpu/optimizer/lr.py``, on the CPU.

Every scheduler is built with the same arguments in both packages: its
first 40 values, the values after ``step(epoch=)`` jumps, and a run
resumed from the other package's ``state_dict`` must agree to 1e-12
relative (the same Python float arithmetic; the tolerance only allows
for ``math.cos`` and ``**`` on another platform). A scheduler bound to an
optimizer writes each value into its f32 device tensor.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu_torch.optimizer import SGD
from paddle_tpu_torch.optimizer import lr as tlr

jlr = paddle.optimizer.lr
RTOL = 1e-12

#: name -> a function of the lr module that builds the scheduler
CASES = {
    "noam": lambda m: m.NoamDecay(d_model=64, warmup_steps=10,
                                  learning_rate=0.5),
    "piecewise": lambda m: m.PiecewiseDecay([5, 15, 30],
                                            [0.1, 0.05, 0.01, 0.001]),
    "natural_exp": lambda m: m.NaturalExpDecay(0.1, gamma=0.05),
    "inverse_time": lambda m: m.InverseTimeDecay(0.1, gamma=0.2),
    "polynomial": lambda m: m.PolynomialDecay(0.1, decay_steps=20,
                                              end_lr=0.001, power=2.0),
    "polynomial_cycle": lambda m: m.PolynomialDecay(
        0.1, decay_steps=12, end_lr=0.001, power=1.5, cycle=True),
    "linear_warmup": lambda m: m.LinearWarmup(0.1, warmup_steps=5,
                                              start_lr=0.0, end_lr=0.1),
    "linear_warmup_cosine": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(2e-3, T_max=8), warmup_steps=2, start_lr=0.0,
        end_lr=2e-3),
    "exponential": lambda m: m.ExponentialDecay(0.1, 0.9),
    "multistep": lambda m: m.MultiStepDecay(0.1, [5, 12, 25], gamma=0.5),
    "step": lambda m: m.StepDecay(0.1, step_size=7, gamma=0.3),
    "lambda": lambda m: m.LambdaDecay(0.1, lambda e: 0.95 ** e),
    "multiplicative": lambda m: m.MultiplicativeDecay(0.1, lambda e: 0.97),
    "reduce_on_plateau": lambda m: m.ReduceOnPlateau(
        0.1, patience=2, cooldown=1, factor=0.5, min_lr=0.004),
    "reduce_on_plateau_max_abs": lambda m: m.ReduceOnPlateau(
        0.1, mode="max", threshold_mode="abs", threshold=0.01, patience=1),
    "cosine": lambda m: m.CosineAnnealingDecay(0.1, T_max=15, eta_min=0.001),
    "cosine_warm_restarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.1, T_0=5, T_mult=2, eta_min=1e-4),
    "linear_lr": lambda m: m.LinearLR(0.1, total_steps=20,
                                      start_factor=0.25),
    "one_cycle": lambda m: m.OneCycleLR(0.1, total_steps=40),
    "one_cycle_linear": lambda m: m.OneCycleLR(
        0.1, total_steps=30, anneal_strategy="linear", phase_pct=0.4),
    "cyclic": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=5,
                                   step_size_down=7),
    "cyclic_triangular2": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=4,
                                               mode="triangular2"),
    "cyclic_exp_range": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=4,
                                             mode="exp_range",
                                             exp_gamma=0.98),
    "cyclic_scale_fn": lambda m: m.CyclicLR(
        0.01, 0.1, step_size_up=3, scale_fn=lambda x: 1.0 / (1.0 + x),
        scale_mode="iterations"),
}

#: a metric that falls, stalls and rises, for ReduceOnPlateau
METRICS = np.concatenate([np.linspace(1.0, 0.5, 8), np.full(10, 0.5),
                          np.linspace(0.5, 0.8, 10), np.full(12, 0.45)])


def _step(sched, i, epoch=None, tensor=None):
    """One step; ReduceOnPlateau gets METRICS[i] (a tensor of the
    scheduler's package when ``tensor`` is given)."""
    if "ReduceOnPlateau" in type(sched).__name__:
        metric = float(METRICS[i % len(METRICS)])
        if tensor is not None:
            metric = tensor(metric)
        sched.step(metric, epoch=epoch)
    else:
        sched.step(epoch)


def _values(sched, n, start=0, tensor=None):
    out = []
    for i in range(n):
        out.append(sched())
        _step(sched, start + i, tensor=tensor)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_first_40_values_match_jax(case):
    want = _values(CASES[case](jlr), 40, tensor=paddle.to_tensor)
    got = _values(CASES[case](tlr), 40, tensor=torch.tensor)
    assert all(isinstance(v, float) for v in got)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_epoch_matches_jax(case):
    j, t = CASES[case](jlr), CASES[case](tlr)
    want, got = [], []
    for i, epoch in enumerate((3, 10, 0, 25, 7, 7, 33)):
        _step(j, i, epoch=epoch)
        _step(t, i, epoch=epoch)
        want.append(j())
        got.append(t())
        assert t.last_epoch == j.last_epoch
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_state_dict_round_trip(case):
    """13 steps in JAX, its state_dict into a fresh port scheduler, 15
    more steps in both; then the port's own state_dict into another port
    scheduler (``set_dict``) resumes the same way."""
    j = CASES[case](jlr)
    _values(j, 13)
    t = CASES[case](tlr)
    t.set_state_dict(j.state_dict())
    assert t() == j()
    want = _values(j, 15, start=13)
    got = _values(t, 15, start=13)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    t2 = CASES[case](tlr)
    t2.set_dict(t.state_dict())
    np.testing.assert_allclose(_values(t2, 5, start=28),
                               _values(t, 5, start=28), rtol=0, atol=0)


def test_bound_scheduler_drives_the_device_rate():
    """A scheduler as ``learning_rate`` writes each value into the
    optimizer's f32 rate; ``set_lr`` raises while it is bound; the
    optimizer's state_dict carries it under ``LR_Scheduler``, and a fresh
    optimizer restored from it resumes the schedule."""
    p = torch.nn.Parameter(torch.ones(3))
    sched = CASES["linear_warmup_cosine"](tlr)
    opt = SGD(learning_rate=sched, parameters=[p])
    for _ in range(6):
        assert opt.get_lr() == float(np.float32(sched()))
        assert opt._lr_tensor.dtype == torch.float32
        sched.step()
    with pytest.raises(RuntimeError):
        opt.set_lr(0.1)
    state = opt.state_dict()
    assert state["LR_Scheduler"]["last_epoch"] == 6
    sched2 = CASES["linear_warmup_cosine"](tlr)
    opt2 = SGD(learning_rate=sched2, parameters=[p])
    opt2.set_state_dict(state)
    assert sched2.last_epoch == 6 and sched2() == sched()
    assert opt2.get_lr() == float(np.float32(sched()))
