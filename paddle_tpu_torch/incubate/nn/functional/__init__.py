"""Fused functional ops of ``incubate.nn`` (counterpart of
``paddle_tpu/incubate/nn/functional/__init__.py``).

Three run through kernels, forward and backward:

- ``fused_bias_dropout_residual_layer_norm`` (:12-61): ``(x + bias) *
  mask + residual`` then layer norm, through
  ``ops/kernels/bias_dropout_ln.py``; the f32 dropout mask (``keep / (1 -
  p)``) is drawn on x's device from the default generator;
- ``fused_dropout_add`` (:153-186): counter-hash dropout of ``x`` plus
  ``y`` through ``ops/kernels/dropout_add.py``, its int32 seed drawn on the
  host;
- ``fused_linear_param_grad_add`` (:189-252): ``dweight += x^T dy`` in
  place through ``ops/kernels/linear_grad_add.py``, the bias sum in plain
  tensor code.

``fused_linear``, ``fused_matmul_bias`` and ``fused_linear_activation``
are ``torch.matmul`` plus bias and activation, as JAX leaves them to XLA.
Each kernel function takes ``plain=True`` to run the plain versions on any
device. The dropout draws come from the port's ``torch.Generator`` s
(``core/generator.py``), not ``jax.random``: the same seed gives other
masks than JAX's.
"""

from __future__ import annotations

import torch

from ....core import generator as _gen
from ....nn import functional as F
from ....nn.functional import layer_norm as fused_layer_norm  # noqa: F401
from ....nn.functional import rms_norm as fused_rms_norm  # noqa: F401
from ....nn.functional import rope as fused_rotary_position_embedding  # noqa: F401
from ....nn.functional import \
    scaled_dot_product_attention as fused_dot_product_attention  # noqa: F401
from ....nn.functional import swiglu  # noqa: F401
from ....ops.kernels import bias_dropout_ln as _bdl
from ....ops.kernels import dropout_add as _da
from ....ops.kernels import linear_grad_add as _lga

__all__ = ["fused_bias_dropout_residual_layer_norm", "fused_linear",
           "fused_dropout_add", "fused_linear_param_grad_add",
           "fused_matmul_bias", "fused_linear_activation", "fused_rms_norm",
           "fused_layer_norm", "fused_rotary_position_embedding", "swiglu",
           "fused_dot_product_attention"]


def dropout_mask(shape, p: float, device):
    """The f32 dropout mask of ``fused_bias_dropout_residual_layer_norm``:
    ``keep / (1 - p)`` with ``keep`` a Bernoulli(1 - p) draw on ``device``
    from the default generator (JAX draws it at :36-43)."""
    keep = torch.empty(shape, device=device).bernoulli_(
        1.0 - p, generator=_gen.default_generator.generator(device))
    return keep / (1.0 - p)


def dropout_seed() -> int:
    """The int32 seed of one ``fused_dropout_add`` call, drawn on the host
    so that drawing it never waits for the card."""
    return _gen.default_generator.random()


def fused_bias_dropout_residual_layer_norm(x, residual, bias=None,
                                           ln_scale=None, ln_bias=None,
                                           dropout_rate=0.0, ln_epsilon=1e-5,
                                           training=True, plain=False):
    """``layer_norm(dropout(x + bias) + residual) * ln_scale + ln_bias``
    through the kernel. The mask is drawn only in training with ``0 <
    dropout_rate < 1``; at ``dropout_rate >= 1`` in training it is zeros;
    otherwise the maskless variant runs. A missing bias, ``ln_scale`` or
    ``ln_bias`` is f32 zeros, ones or zeros (:44-47), and gets no
    gradient."""
    hd = x.shape[-1]
    if training and dropout_rate >= 1.0:
        mask = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    elif training and dropout_rate > 0.0:
        mask = dropout_mask(x.shape, dropout_rate, x.device)
    else:
        mask = None
    zeros = torch.zeros(hd, dtype=torch.float32, device=x.device)
    b = zeros if bias is None else bias
    g = zeros + 1.0 if ln_scale is None else ln_scale
    be = zeros if ln_bias is None else ln_bias
    if F._needs_grad(x, residual, b, g, be):
        return _bdl.BiasDropoutLNFunction.apply(x, b, residual, mask, g, be,
                                                ln_epsilon, plain)[0]
    fn = _bdl.bias_dropout_ln_plain if plain else _bdl.bias_dropout_ln
    return fn(x, b, residual, mask, g, be, ln_epsilon)[0]


def fused_linear(x, weight, bias=None, transpose_weight=False):
    """``x @ weight + bias`` with Paddle's ``[in, out]`` weight
    (``[out, in]`` with ``transpose_weight``)."""
    out = torch.matmul(x, weight.t() if transpose_weight else weight)
    return out if bias is None else out + bias


def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train",
                      name=None, plain=False):
    """``dropout(x, p) + y``. The kernel runs exactly where JAX's does but
    for size: in training, ``mode == 'upscale_in_train'``, ``x`` and ``y``
    of one shape and dtype, and ``0 < p < 1`` (JAX also asks for 1024
    elements, ``dropout_add_pallas.py:172-175``; the port's kernel takes
    small tensors too). Every other case is JAX's composite,
    ``nn.functional.dropout(x, p, training, mode) + y``."""
    if (training and mode == "upscale_in_train" and x.shape == y.shape
            and x.dtype == y.dtype and 0.0 < p < 1.0):
        seed = dropout_seed()
        if F._needs_grad(x, y):
            return _da.DropoutAddFunction.apply(x, y, seed, float(p), plain)
        fn = _da.dropout_add_plain if plain else _da.dropout_add
        return fn(x, y, seed, float(p))
    return F.dropout(x, p, training=training, mode=mode) + y


def fused_linear_param_grad_add(x, dy, dweight=None, dbias=None,
                                multi_precision=False, has_bias=False,
                                plain=False):
    """Accumulate a linear layer's parameter gradients: ``dweight [K, N] +=
    flatten(x)^T @ flatten(dy)`` through the kernel, and with ``has_bias``
    ``dbias [N] += sum(dy)`` (an f32 sum, cast to the accumulator's dtype).
    The inputs are detached; the function is not differentiable. A
    missing accumulator starts as zeros, f32 under ``multi_precision``,
    else x's dtype. Given accumulators are updated in place (JAX returns
    new arrays). Returns ``(dweight, dbias or None)``."""
    x, dy = x.detach(), dy.detach()
    k, n = x.shape[-1], dy.shape[-1]
    acc_dtype = torch.float32 if multi_precision else x.dtype
    x2, dy2 = x.reshape(-1, k), dy.reshape(-1, n)
    acc = torch.zeros(k, n, dtype=acc_dtype, device=x.device) \
        if dweight is None else dweight.detach()
    fn = _lga.linear_grad_add_plain if plain else _lga.linear_grad_add
    fn(x2, dy2, acc)
    dw = acc if dweight is None else dweight
    if not has_bias:
        return dw, None
    s = dy2.float().sum(0)
    if dbias is None:
        return dw, s.to(acc_dtype)
    db = dbias.detach()
    db.copy_((s + db.float()).to(db.dtype))
    return dw, dbias


def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False,
                      name=None):
    """``x @ y + bias`` (reference ``fused_matmul_bias.py:21``)."""
    out = torch.matmul(x.transpose(-1, -2) if transpose_x else x,
                       y.transpose(-1, -2) if transpose_y else y)
    return out if bias is None else out + bias


def fused_linear_activation(x, y, bias, trans_x=False, trans_y=False,
                            activation=None):
    """``activation(x @ y + bias)``, activation None, "gelu" (erf form) or
    "relu" (reference ``fused_matmul_bias.py:110``)."""
    out = fused_matmul_bias(x, y, bias, trans_x, trans_y)
    if activation in (None, "", "none"):
        return out
    if activation == "gelu":
        return F.gelu(out)
    if activation == "relu":
        return torch.relu(out)
    raise ValueError(f"unsupported activation {activation!r}")
