"""Functional ops of the Llama and GPT serving and training paths
(counterparts of ``paddle_tpu/nn/functional/__init__.py`` ``layer_norm``
(:65), ``rms_norm`` (:90), ``fused_rms_norm_add`` (:115),
``fused_dropout_add_norm`` (:139), ``scaled_dot_product_attention``
(:391), ``rope`` (:505), ``dropout`` (:295),
``paddle_tpu/ops/activation.py`` ``gelu`` (:44) and ``swiglu`` (:159),
and ``paddle_tpu/nn/functional/loss.py`` ``cross_entropy`` (:32-79) and
``softmax_with_cross_entropy`` (:81-90)).

Dispatch is the kernel wrapper's: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel or raises. ``plain=True`` runs the plain
PyTorch version on any device; it exists so a check on the card can hold
the kernel path against the plain one on the same inputs. ``layer_norm``,
``gelu`` and the cross entropies are plain tensor code, as the JAX package
computes them outside any Pallas kernel.

Where grad is enabled and an operand requires it, each kernel op goes
through its ``torch.autograd.Function``, whose backward is the backward
kernel (or, with ``plain=True``, the plain backward); otherwise it calls
the forward wrapper directly, as the serving path always has.
"""

from __future__ import annotations

import torch

from ..core import generator as _gen
from ..ops.kernels import block_epilogue as _bep
from ..ops.kernels import flash_attention as _fa
from ..ops.kernels import rms_norm as _rms
from ..ops.kernels import rope as _rope
from ..ops.kernels import swiglu as _swiglu

__all__ = ["layer_norm", "gelu", "dropout", "rms_norm", "fused_rms_norm_add",
           "fused_dropout_add_norm", "scaled_dot_product_attention", "rope",
           "swiglu", "cross_entropy", "softmax_with_cross_entropy"]


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def layer_norm(x, normalized_shape=None, weight=None, bias=None,
               epsilon=1e-5):
    """Layer norm over the last ``len(normalized_shape)`` dims (default
    1), with JAX's rounding: statistics in f32 for a bf16 or f16 ``x``,
    the normalised value cast to x's dtype, then ``* weight + bias``."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    n_axes = len(normalized_shape) if normalized_shape is not None else 1
    dims = tuple(range(x.dim() - n_axes, x.dim()))
    xf = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    mean = xf.mean(dims, keepdim=True)
    var = (xf - mean).square().mean(dims, keepdim=True)
    out = ((xf - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def gelu(x, approximate=False):
    """GELU, the tanh form with ``approximate=True`` (GPT's MLP), else the
    erf form, in x's dtype."""
    return torch.nn.functional.gelu(x, approximate="tanh" if approximate
                                    else "none")


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train"):
    """Dropout in plain tensor code, as JAX's composite (:295-313): off in
    eval or at ``p == 0`` (``downscale_in_infer`` scales by ``1 - p`` in
    eval); in training, a Bernoulli keep mask over ``x``'s shape (1 on the
    axes not in ``axis``) drawn on x's device from the default generator,
    and the kept values divided by ``1 - p`` (``upscale_in_train``) or
    kept as they are (``downscale_in_infer``), in x's dtype."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout mode must be 'upscale_in_train' or "
                         f"'downscale_in_infer', got {mode!r}")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    axes = None if axis is None else \
        {a % x.dim() for a in ([axis] if isinstance(axis, int) else axis)}
    shape = tuple(n if axes is None or i in axes else 1
                  for i, n in enumerate(x.shape))
    keep = torch.empty(shape, device=x.device).bernoulli_(
        1.0 - p, generator=_gen.default_generator.generator(x.device)) > 0
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, torch.zeros((), dtype=x.dtype,
                                               device=x.device))


def rms_norm(x, weight, epsilon=1e-6, plain=False):
    if _needs_grad(x, weight):
        return _rms.RMSNormFunction.apply(x, weight, None, epsilon, plain)
    fn = _rms.rms_norm_plain if plain else _rms.rms_norm
    return fn(x, weight, None, epsilon)


def fused_rms_norm_add(x, residual, weight, epsilon=1e-6, plain=False):
    """``(rmsnorm(x + residual) * weight, x + residual)``."""
    if _needs_grad(x, residual, weight):
        return _rms.RMSNormFunction.apply(x, weight, residual, epsilon, plain)
    fn = _rms.rms_norm_plain if plain else _rms.rms_norm
    return fn(x, weight, residual, epsilon)


def fused_dropout_add_norm(x, residual, weight, bias=None, p=0.0,
                           epsilon=1e-6, norm="rms", activation=None, seed=0,
                           training=True, plain=False):
    """Transformer-block epilogue: ``activation(x)`` -> dropout ->
    ``+ residual`` -> rms/layer norm in one pass. Returns ``(y, h)``, the
    normalized output and the pre-norm sum.

    ``norm`` "rms" (no bias) | "layer"; ``activation`` None | "gelu" (tanh
    form) | "swiglu" (x packed ``[.., 2I]``, residual ``[.., I]``). The
    dropout mask is a counter hash of ``seed`` (an int32) and the element
    index, the same bits as the JAX package's for the same seed; the seed
    is an argument here, never drawn from a framework generator.
    ``training=False`` turns dropout off."""
    args = (int(seed), float(p) if training else 0.0, epsilon, activation,
            norm)
    if _needs_grad(x, residual, weight, bias):
        return _bep.BlockEpilogueFunction.apply(x, residual, weight, bias,
                                                *args, plain)
    fn = _bep.fused_epilogue_plain if plain else _bep.fused_epilogue
    return fn(x, residual, weight, bias, *args)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, plain=False):
    """SDPA in the ``[B, S, H, D]`` layout through the flash-attention
    kernel; ``key``/``value`` may carry fewer heads (GQA). An attention
    mask or dropout is not ported yet and raises."""
    if attn_mask is not None or (dropout_p > 0.0 and training):
        raise NotImplementedError(
            "scaled_dot_product_attention: attn_mask and dropout are not "
            "ported yet; only the flash-attention case (no mask, no "
            "dropout) is")
    return flash_attention(query, key, value, causal=is_causal, plain=plain)


def flash_attention(q, k, v, causal=False, segment_ids=None, plain=False):
    """``[B, S, H, D]`` attention (``paddle_tpu/ops/kernels/
    flash_attention.py`` ``flash_attention`` :213): causal or full, with
    optional int ``segment_ids [B, S]`` (a query sees only keys of its own
    segment); ``k``/``v`` may carry fewer heads (GQA). Differentiable
    through the backward kernels."""
    if segment_ids is not None:
        segment_ids = segment_ids.to(torch.int32)
    if _needs_grad(q, k, v):
        return _fa.FlashAttentionFunction.apply(q, k, v, causal, segment_ids,
                                                plain)
    return _fa.flash_attention_forward(q, k, v, causal=causal,
                                       segment_ids=segment_ids, plain=plain)


def rope(q, k, sin, cos, plain=False):
    """Rotate-half RoPE on ``q`` and ``k`` ``[B, S, H, D]``; ``cos``/``sin``
    are f32 tables ``[S, D]`` or ``[B*S, D]`` (one row per token)."""
    def one(x):
        if _needs_grad(x):
            return _rope.RoPEFunction.apply(x, cos, sin, plain)
        return (_rope.rope_plain if plain else _rope.rope_apply)(x, cos, sin)
    return one(q), one(k)


def swiglu(x, y=None, plain=False):
    """``silu(x) * y``; with ``y`` None, ``x`` is packed ``[.., 2I]`` (gate
    half first) and the gate runs on both halves in place."""
    if y is None:
        if _needs_grad(x):
            return _swiglu.SwiGLUPackedFunction.apply(x, plain)
        fn = _swiglu.swiglu_packed_plain if plain else _swiglu.swiglu_packed
        return fn(x)
    if _needs_grad(x, y):
        return _swiglu.SwiGLUFunction.apply(x, y, plain)
    fn = _swiglu.swiglu_plain if plain else _swiglu.swiglu
    return fn(x, y)


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"cross_entropy: reduction must be 'mean', 'sum' or "
                     f"'none', got {reduction!r}")


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """Softmax cross entropy in plain PyTorch with the log-softmax in f32
    (``paddle_tpu/nn/functional/loss.py:32-79``; ``use_softmax=False``
    takes ``input`` as probabilities). Hard labels: labels equal to
    ``ignore_index`` add nothing and leave the mean's denominator; an
    optional per-class ``weight`` scales each row's loss, and the weighted
    mean divides by the weights of the counted rows. ``soft_label=True``:
    ``label`` is a distribution over the classes, the loss
    ``-sum(label * logp)`` (times ``weight`` per class) and the mean a
    plain one over the rows. ``label_smoothing`` mixes each hard target
    with the mean log-probability, and each soft target with the uniform
    distribution."""
    x = input.float()
    logp = torch.log_softmax(x, dim=axis) if use_softmax \
        else torch.log(x.clamp_min(1e-12))
    n_class = logp.shape[axis]
    if soft_label:
        tgt = label.to(logp.dtype)
        if label_smoothing > 0.0:
            tgt = (1 - label_smoothing) * tgt + label_smoothing / n_class
        if weight is not None:
            shape = [1] * logp.dim()
            shape[axis] = n_class
            tgt = tgt * weight.to(device=logp.device,
                                  dtype=logp.dtype).reshape(shape)
        return _reduce(-(tgt * logp).sum(dim=axis), reduction)
    idx = label
    if idx.dim() == logp.dim() and idx.shape[axis] == 1:
        idx = idx.squeeze(axis)
    idx = idx.long()
    valid = idx != ignore_index
    safe = torch.where(valid, idx, torch.zeros_like(idx))
    picked = logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    if label_smoothing > 0.0:
        picked = (1 - label_smoothing) * picked \
            + label_smoothing * logp.mean(dim=axis)
    zero = torch.zeros((), dtype=logp.dtype, device=logp.device)
    loss = -picked
    if weight is not None:
        cw = weight.to(device=logp.device, dtype=logp.dtype)[safe]
        loss = torch.where(valid, loss * cw, zero)
        if reduction == "mean":
            return loss.sum() / torch.where(valid, cw, zero).sum().clamp_min(
                1e-12)
    else:
        loss = torch.where(valid, loss, zero)
        if reduction == "mean":
            return loss.sum() / valid.sum().to(loss.dtype).clamp_min(1.0)
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """The per-row loss of :func:`cross_entropy` (``reduction="none"``;
    ``paddle_tpu/nn/functional/loss.py:81-90``) and, with
    ``return_softmax=True``, also ``softmax(logits)`` in the logits'
    dtype."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss
