"""paddle_tpu_torch's loss surface (``nn/loss.py``, ``nn/layers/loss.py``)
against the JAX package's, on the CPU.

Every function of ``paddle_tpu/nn/functional/loss.py`` from
``binary_cross_entropy`` to ``edit_distance`` and every layer of
``paddle_tpu/nn/layers/loss.py`` runs on the same seeded numpy inputs in
both packages: the value and, where the loss is differentiable, the
gradient of its sum with respect to the first input. Each JAX reference is
computed once for the module. Tolerance: f32 ``rtol``/``atol`` 2e-4 (the
JAX tests').
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF

TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs():
    """name -> (positional numpy inputs, keywords, differentiable first
    input?) for every loss function."""
    r = np.random.default_rng(0)

    def f32(*shape, lo=None, hi=None):
        if lo is not None:
            return r.uniform(lo, hi, shape).astype(np.float32)
        return r.standard_normal(shape).astype(np.float32)

    def sig(x):
        return (1 / (1 + np.exp(-x))).astype(np.float32)

    def logsm(x):
        x = x - x.max(-1, keepdims=True)
        return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(
            np.float32)

    pm1 = np.where(r.random((4, 5)) < 0.5, -1.0, 1.0).astype(np.float32)
    pm1v = np.where(r.random(6) < 0.5, -1.0, 1.0).astype(np.float32)
    bits = (r.random((4, 5)) < 0.4).astype(np.float32)
    nll_lbl = np.array([0, 3, -100, 4, 1, 2], np.int64)
    probs = np.exp(logsm(f32(4, 5)))
    return {
        "binary_cross_entropy": ([sig(f32(4, 5)), f32(4, 5, lo=0, hi=1)],
                                 dict(weight=f32(4, 5, lo=0.5, hi=1.5)),
                                 True),
        "binary_cross_entropy_with_logits": (
            [f32(4, 5), f32(4, 5, lo=0, hi=1)],
            dict(reduction="sum", pos_weight=f32(5, lo=0.5, hi=2)), True),
        "mse_loss": ([f32(4, 5), f32(4, 5)], dict(reduction="none"), True),
        "l1_loss": ([f32(4, 5), f32(4, 5)], {}, True),
        "square_error_cost": ([f32(4, 5), f32(4, 5)], {}, True),
        "log_loss": ([sig(f32(4, 1)), bits[:, :1]], {}, True),
        "nll_loss": ([logsm(f32(6, 5)), nll_lbl],
                     dict(weight=f32(5, lo=0.5, hi=2)), True),
        "kl_div": ([logsm(f32(4, 5)), probs], dict(reduction="batchmean"),
                   True),
        "smooth_l1_loss": ([f32(4, 5), f32(4, 5)], dict(delta=0.5), True),
        "margin_ranking_loss": ([f32(6), f32(6), pm1v], dict(margin=0.1),
                                True),
        "cosine_embedding_loss": ([f32(6, 4), f32(6, 4), pm1v],
                                  dict(margin=0.2), True),
        "hinge_embedding_loss": ([f32(4, 5), pm1], dict(margin=0.5), True),
        "triplet_margin_loss": ([f32(4, 6), f32(4, 6), f32(4, 6)],
                                dict(swap=True, margin=0.5), True),
        "sigmoid_focal_loss": ([f32(4, 5), bits],
                               dict(normalizer=np.float32(3.0)), True),
        "dice_loss": ([np.exp(logsm(f32(2, 3, 5))),
                       r.integers(0, 5, (2, 3, 1))], {}, True),
        "ctc_loss": ([f32(6, 2, 5), np.array([[1, 2, 2], [3, 4, 0]]),
                      np.array([6, 5]), np.array([3, 2])], {}, True),
        "poisson_nll_loss": ([f32(4, 5), r.poisson(2.0, (4, 5)).astype(
            np.float32)], dict(full=True), True),
        "multi_label_soft_margin_loss": ([f32(4, 5), bits],
                                         dict(weight=f32(4, lo=0.5, hi=2)),
                                         True),
        "soft_margin_loss": ([f32(4, 5), pm1], {}, True),
        "npair_loss": ([f32(4, 6), f32(4, 6), np.array([1, 2, 1, 3])], {},
                       True),
        "multi_margin_loss": ([f32(5, 4), np.array([0, 3, 1, 2, 3])],
                              dict(p=2, weight=f32(4, lo=0.5, hi=2)), True),
        "gaussian_nll_loss": ([f32(4, 5), f32(4, 5), f32(4, 5, lo=0.1, hi=2)],
                              dict(full=True), True),
        "triplet_margin_with_distance_loss": (
            [f32(4, 6), f32(4, 6), f32(4, 6)], dict(swap=True), True),
        "margin_cross_entropy": ([f32(4, 6, lo=-0.9, hi=0.9),
                                  np.array([1, 0, 5, 3])], {}, True),
        "hsigmoid_loss": ([f32(4, 3), np.array([0, 5, 2, 3]), 6, f32(5, 3),
                           f32(5)], {}, True),
        "rnnt_loss": ([f32(2, 4, 3, 5), np.array([[1, 2], [3, 0]]),
                       np.array([4, 3]), np.array([2, 1])], {}, True),
        "edit_distance": ([np.array([[1, 2, 3, 0], [4, 4, 2, 1]]),
                           np.array([[1, 3, 3], [4, 0, 1]])],
                          dict(ignored_tokens=[0],
                               input_length=np.array([4, 3]),
                               label_length=np.array([3, 3])), False),
    }


CASES = _inputs()
FUNCTIONS = sorted(CASES)


def _jax_run(fn, args, kw, grad):
    ts = [paddle.to_tensor(a) if isinstance(a, np.ndarray) else a
          for a in args]
    if grad:
        ts[0].stop_gradient = False
    out = fn(*ts, **{k: paddle.to_tensor(v) if isinstance(v, np.ndarray)
                     else v for k, v in kw.items()})
    if isinstance(out, tuple):
        return [np.asarray(o.numpy()) for o in out], None
    g = None
    if grad:
        out.sum().backward()
        g = np.asarray(ts[0].grad.numpy())
    return [np.asarray(out.numpy())], g


def _torch_run(fn, args, kw, grad):
    ts = [torch.from_numpy(np.ascontiguousarray(a))
          if isinstance(a, np.ndarray) else a for a in args]
    if grad:
        ts[0] = ts[0].clone().requires_grad_(True)
    out = fn(*ts, **{k: torch.from_numpy(v) if isinstance(v, np.ndarray)
                     else v for k, v in kw.items()})
    if isinstance(out, tuple):
        return [o.detach().numpy() for o in out], None
    g = None
    if grad:
        out.sum().backward()
        g = ts[0].grad.numpy()
    return [out.detach().numpy()], g


@pytest.fixture(scope="module")
def jax_functions():
    """Each function's JAX value and gradient, computed once."""
    return {name: _jax_run(getattr(JF, name), *CASES[name])
            for name in FUNCTIONS}


def test_every_jax_loss_function_is_ported():
    want = [n for n in JF.loss.__all__
            if n not in ("cross_entropy", "softmax_with_cross_entropy")]
    assert sorted(want) == FUNCTIONS
    assert all(callable(getattr(TF, n)) for n in want)


@pytest.mark.parametrize("name", FUNCTIONS)
def test_function_matches_jax(name, jax_functions):
    """Value (every output) and the gradient of its sum."""
    want, want_g = jax_functions[name]
    got, got_g = _torch_run(getattr(TF, name), *CASES[name])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape, (a.shape, b.shape)
        np.testing.assert_allclose(a, b, **TOL)
    if want_g is not None:
        np.testing.assert_allclose(got_g, want_g, **TOL)


def _layer_cases():
    """layer name -> (constructor keywords, function case whose inputs it
    takes, positional inputs to drop from that case)."""
    return {
        "CrossEntropyLoss": (dict(label_smoothing=0.1, ignore_index=2),
                             "nll_loss", None),
        "MSELoss": (dict(reduction="sum"), "mse_loss", None),
        "L1Loss": ({}, "l1_loss", None),
        "NLLLoss": (dict(reduction="sum"), "nll_loss", None),
        "BCELoss": ({}, "binary_cross_entropy", None),
        "BCEWithLogitsLoss": (dict(reduction="none"),
                              "binary_cross_entropy_with_logits", None),
        "KLDivLoss": (dict(reduction="sum"), "kl_div", None),
        "SmoothL1Loss": (dict(delta=2.0), "smooth_l1_loss", None),
        "MarginRankingLoss": (dict(margin=0.3), "margin_ranking_loss", None),
        "CosineEmbeddingLoss": (dict(margin=0.1), "cosine_embedding_loss",
                                None),
        "HingeEmbeddingLoss": ({}, "hinge_embedding_loss", None),
        "TripletMarginLoss": (dict(p=1.0), "triplet_margin_loss", None),
        "PoissonNLLLoss": (dict(log_input=True), "poisson_nll_loss", None),
        "SoftMarginLoss": (dict(reduction="sum"), "soft_margin_loss", None),
        "MultiLabelSoftMarginLoss": ({}, "multi_label_soft_margin_loss",
                                     None),
        "CTCLoss": (dict(reduction="sum"), "ctc_loss", None),
        "MultiMarginLoss": (dict(margin=0.5), "multi_margin_loss", None),
        "GaussianNLLLoss": ({}, "gaussian_nll_loss", None),
        "TripletMarginWithDistanceLoss": (dict(margin=0.2),
                                          "triplet_margin_with_distance_loss",
                                          None),
        "HSigmoidLoss": (dict(feature_size=3, num_classes=6),
                         "hsigmoid_loss", (2, 3, 4)),
        "RNNTLoss": (dict(fastemit_lambda=0.01), "rnnt_loss", None),
    }


LAYERS = _layer_cases()


def _layer_args(name):
    _, case, drop = LAYERS[name]
    args = CASES[case][0]
    if name == "CrossEntropyLoss":
        args = [args[0], np.array([0, 3, 2, 4, 1, 2], np.int64)]
    if drop:
        args = [a for i, a in enumerate(args) if i not in drop]
    return args


@pytest.fixture(scope="module")
def jax_layers():
    """Each layer's JAX value and input gradient (and state, for the layer
    with parameters), computed once."""
    out = {}
    for name, (kw, _, _) in LAYERS.items():
        paddle.seed(3)
        layer = getattr(jnn, name)(**kw)
        state = {k: np.asarray(v.numpy())
                 for k, v in layer.state_dict().items()}
        out[name] = _jax_run(layer, _layer_args(name), {}, True) + (state,)
    return out


def test_every_jax_loss_layer_is_ported():
    from paddle_tpu.nn.layers import loss as jl
    assert sorted(jl.__all__) == sorted(LAYERS)
    assert all(issubclass(getattr(tnn, n), torch.nn.Module) for n in LAYERS)


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name, jax_layers):
    want, want_g, state = jax_layers[name]
    kw = dict(LAYERS[name][0])
    if name == "HSigmoidLoss":
        kw["device"] = "cpu"
    layer = getattr(tnn, name)(**kw)
    if state:
        layer.load_state_dict({k: torch.from_numpy(v)
                               for k, v in state.items()})
    got, got_g = _torch_run(layer, _layer_args(name), {}, True)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got_g, want_g, **TOL)
