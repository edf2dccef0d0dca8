"""paddle_tpu_torch's ``nn.functional.cross_entropy`` options and
``softmax_with_cross_entropy`` against the JAX package's
``paddle_tpu/nn/functional/loss.py``, on the CPU.

Logits and labels are made with numpy from a seed; the same f32 formula
runs in both packages, so every loss, its gradient and the softmax agree
to 1e-6 (absolute and relative).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.nn import functional as TF

TOL = dict(rtol=1e-6, atol=1e-6)
N, C = 12, 7


def _data(seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((N, C)).astype(np.float32) * 2
    hard = rng.integers(0, C, N)
    hard[[2, 9]] = -100
    soft = rng.dirichlet(np.ones(C), N).astype(np.float32)
    weight = rng.uniform(0.5, 2.0, C).astype(np.float32)
    probs = rng.dirichlet(np.ones(C), N).astype(np.float32)
    return logits, hard, soft, weight, probs


def _both(kw, label, x, weight=None):
    """(port loss and d/dx, JAX loss and d/dx) of ``sum(cross_entropy)``
    at logits ``x``."""
    jx = paddle.to_tensor(x, stop_gradient=False)
    jkw = dict(kw, **({"weight": paddle.to_tensor(weight)}
                      if weight is not None else {}))
    jl = JF.cross_entropy(jx, paddle.to_tensor(label), **jkw)
    paddle.sum(jl).backward()
    tx = torch.from_numpy(x).requires_grad_()
    tkw = dict(kw, **({"weight": torch.from_numpy(weight)}
                      if weight is not None else {}))
    tl = TF.cross_entropy(tx, torch.from_numpy(label), **tkw)
    tl.sum().backward()
    return (tl.detach().numpy(), tx.grad.numpy(),
            np.asarray(jl.numpy()), np.asarray(jx.grad.numpy()))


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_soft_labels_match_jax(reduction, weighted, smoothing):
    logits, _, soft, weight, _ = _data(1)
    got, gx, want, wx = _both(
        dict(soft_label=True, reduction=reduction,
             label_smoothing=smoothing), soft, logits,
        weight if weighted else None)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(gx, wx, **TOL)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("weighted", [False, True])
def test_hard_label_smoothing_matches_jax(reduction, weighted):
    logits, hard, _, weight, _ = _data(2)
    got, gx, want, wx = _both(dict(label_smoothing=0.2, reduction=reduction),
                              hard, logits, weight if weighted else None)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(gx, wx, **TOL)


@pytest.mark.parametrize("soft_label", [False, True])
def test_use_softmax_false_matches_jax(soft_label):
    """``use_softmax=False``: the input is taken as probabilities."""
    _, hard, soft, _, probs = _data(3)
    got, gx, want, wx = _both(dict(use_softmax=False, soft_label=soft_label,
                                   reduction="none"),
                              soft if soft_label else hard, probs)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(gx, wx, **TOL)


@pytest.mark.parametrize("soft_label", [False, True])
@pytest.mark.parametrize("return_softmax", [False, True])
def test_softmax_with_cross_entropy_matches_jax(soft_label, return_softmax):
    logits, hard, soft, _, _ = _data(4)
    label = soft if soft_label else hard
    want = JF.softmax_with_cross_entropy(
        paddle.to_tensor(logits), paddle.to_tensor(label),
        soft_label=soft_label, return_softmax=return_softmax)
    got = TF.softmax_with_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(label),
        soft_label=soft_label, return_softmax=return_softmax)
    if not return_softmax:
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b.numpy()), **TOL)


def test_bad_reduction_raises():
    logits, hard, _, _, _ = _data(5)
    with pytest.raises(ValueError):
        TF.cross_entropy(torch.from_numpy(logits), torch.from_numpy(hard),
                         reduction="max")
