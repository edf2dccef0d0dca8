"""The cross-entropy row-statistics kernel's plain version and the loss
around it against the JAX package's ``ce_pallas`` (the Pallas kernel in
interpret mode) and ``ParallelCrossEntropy``, on the CPU.

Logits are made with numpy from a seed at vocab 1000 (not a multiple of
128) and 50304 (GPT-2's, in bf16). Tolerances: the row max and the target
logit exactly (the same f32 values read); the sum of exponentials to 1e-6
relative (summed in another order); the loss to 1e-6 relative and its
gradient to 1e-6 absolute (softmax - onehot, the same f32 formula), bf16
gradients to one bf16 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.meta_parallel import \
    ParallelCrossEntropy as JaxPCE
from paddle_tpu.ops.kernels import _common as jax_kern
from paddle_tpu.ops.kernels import ce_pallas
from paddle_tpu_torch.distributed import ParallelCrossEntropy
from paddle_tpu_torch.ops.kernels import WRAPPERS, parallel_ce

LOSS_TOL = dict(rtol=1e-6, atol=1e-6)
GRAD_TOL = dict(rtol=0, atol=1e-6)


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    for w in WRAPPERS.values():
        w.launches = 0
    yield
    assert all(w.launches == 0 for w in WRAPPERS.values())


def _logits(shape, seed, scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _labels(shape, hi, seed, ignore=()):
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, hi, shape).astype(np.int64)
    for i in ignore:
        lab.reshape(-1)[i] = -100
    return lab


@pytest.mark.parametrize("n,v,vocab_start,dtype", [
    (37, 1000, 0, "float32"), (37, 1000, 300, "float32"),
    (16, 1000, 0, "bfloat16"), (4, 50304, 0, "bfloat16"),
    (9, 130, 7, "float32")])
def test_row_stats_match_interpret_kernel(n, v, vocab_start, dtype):
    x = _logits((n, v), seed=n + v)
    labels = _labels((n,), vocab_start + v + 200, seed=v)
    labels[0] = vocab_start + v + 5          # outside this shard
    jx = jnp.asarray(x).astype(dtype)
    mx, se, tg = ce_pallas._row_stats(jx, jnp.asarray(labels, jnp.int32),
                                      vocab_start, True)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = parallel_ce.row_stats(tx, torch.from_numpy(labels), vocab_start)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(mx))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(se), rtol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(tg))
    outside = (labels < vocab_start) | (labels >= vocab_start + v)
    assert outside.any() and (got[2].numpy()[outside] == -1e30).all()


@pytest.mark.parametrize("vocab_start", [0, 250])
@pytest.mark.parametrize("ignore_index", [None, -100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grad_match_jax_vjp(vocab_start, ignore_index, dtype):
    """The loss and its gradient against ``jax.vjp`` of JAX's
    ``c_softmax_with_cross_entropy`` (kernel in interpret mode), for
    logits [2, 6, 1000] with ignored rows and labels partly outside the
    shard when ``vocab_start`` is not 0."""
    shape, v = (2, 6), 1000
    x = _logits(shape + (v,), seed=3)
    labels = _labels(shape, vocab_start + v, seed=4,
                     ignore=(1, 7) if ignore_index is not None else ())
    dloss = np.random.default_rng(5).uniform(0.5, 1.5, shape).astype(
        np.float32)
    jx = jnp.asarray(x).astype(dtype)

    def f(lg):
        return ce_pallas.c_softmax_with_cross_entropy(
            lg, jnp.asarray(labels, jnp.int32), vocab_start, None, True,
            ignore_index)

    jloss, vjp = jax.vjp(f, jx)
    (jgrad,) = vjp(jnp.asarray(dloss))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype)).requires_grad_()
    loss = parallel_ce.c_softmax_with_cross_entropy(
        tx, torch.from_numpy(labels), vocab_start, ignore_index)
    loss.backward(torch.from_numpy(dloss))
    assert loss.dtype == torch.float32 and loss.shape == shape
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jloss),
                               **LOSS_TOL)
    assert tx.grad.dtype == tx.dtype
    want = np.asarray(jgrad.astype(jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_allclose(tx.grad.float().numpy(), want,
                                   rtol=2.0 ** -7, atol=1e-6)
    else:
        np.testing.assert_allclose(tx.grad.numpy(), want, **GRAD_TOL)
    if ignore_index is not None:
        flat = tx.grad.float().reshape(-1, v)
        assert not flat[[1, 7]].any()


def test_plain_flag_takes_the_plain_version():
    x = torch.from_numpy(_logits((5, 1000), seed=8))
    lab = torch.from_numpy(_labels((5,), 1000, seed=9))
    a = parallel_ce.c_softmax_with_cross_entropy(x, lab, plain=True)
    b = parallel_ce.c_softmax_with_cross_entropy(x, lab)
    assert torch.equal(a, b)


@pytest.mark.parametrize("interpret", [True, False])
@pytest.mark.parametrize("label_dims", [2, 3])
def test_parallel_cross_entropy_matches_jax(interpret, label_dims):
    """``ParallelCrossEntropy()(logits, labels)`` and its gradient against
    JAX's layer, whose single-device path runs the kernel in interpret mode
    (``interpret``) or ``F.cross_entropy`` otherwise; labels [B, S] or
    [B, S, 1], two of them at ``ignore_index``."""
    x = _logits((2, 5, 1000), seed=10)
    labels = _labels((2, 5), 1000, seed=11, ignore=(2, 9))
    if label_dims == 3:
        labels = labels[..., None]
    jax_kern.force_interpret(interpret)
    try:
        jx = paddle.to_tensor(x, stop_gradient=False)
        jl = JaxPCE()(jx, paddle.to_tensor(labels))
        paddle.sum(jl * 0.5).backward()
        want, want_g = np.asarray(jl.numpy()), np.asarray(jx.grad.numpy())
    finally:
        jax_kern.force_interpret(False)
    tx = torch.from_numpy(x).requires_grad_()
    got = ParallelCrossEntropy()(tx, torch.from_numpy(labels))
    (got * 0.5).sum().backward()
    assert got.shape == (2, 5)
    np.testing.assert_allclose(got.detach().numpy(), want, **LOSS_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), want_g, **GRAD_TOL)


def test_mp_group_and_bad_operands_raise():
    with pytest.raises(NotImplementedError):
        ParallelCrossEntropy(mp_group=object())
    x = torch.zeros(3, 10)
    with pytest.raises(ValueError):
        parallel_ce.row_stats(x, torch.zeros(4, dtype=torch.int64))
    with pytest.raises(TypeError):
        parallel_ce.row_stats(x, torch.zeros(3))
