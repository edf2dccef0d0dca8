"""Functional ops of the Llama serving path (counterparts of
``paddle_tpu/nn/functional/__init__.py`` ``rms_norm`` (:90),
``fused_rms_norm_add`` (:115), ``fused_dropout_add_norm`` (:139),
``scaled_dot_product_attention`` (:391), ``rope`` (:505) and
``paddle_tpu/ops/activation.py`` ``swiglu`` (:159)).

Dispatch is the kernel wrapper's: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel or raises. ``plain=True`` runs the plain
PyTorch version on any device; it exists so a check on the card can hold
the kernel path against the plain one on the same inputs.
"""

from __future__ import annotations

from ..ops.kernels import block_epilogue as _bep
from ..ops.kernels import flash_attention as _fa
from ..ops.kernels import rms_norm as _rms
from ..ops.kernels import rope as _rope
from ..ops.kernels import swiglu as _swiglu

__all__ = ["rms_norm", "fused_rms_norm_add", "fused_dropout_add_norm",
           "scaled_dot_product_attention", "rope", "swiglu"]


def rms_norm(x, weight, epsilon=1e-6, plain=False):
    fn = _rms.rms_norm_plain if plain else _rms.rms_norm
    return fn(x, weight, None, epsilon)


def fused_rms_norm_add(x, residual, weight, epsilon=1e-6, plain=False):
    """``(rmsnorm(x + residual) * weight, x + residual)``."""
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
    fn = _bep.fused_epilogue_plain if plain else _bep.fused_epilogue
    return fn(x, residual, weight, bias, int(seed),
              float(p) if training else 0.0, epsilon, activation, norm)


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
    return _fa.flash_attention_forward(query, key, value, causal=is_causal,
                                       plain=plain)


def rope(q, k, sin, cos, plain=False):
    """Rotate-half RoPE on ``q`` and ``k`` ``[B, S, H, D]``; ``cos``/``sin``
    are f32 tables ``[S, D]`` or ``[B*S, D]`` (one row per token)."""
    fn = _rope.rope_plain if plain else _rope.rope_apply
    return fn(q, cos, sin), fn(k, cos, sin)


def swiglu(g, u, plain=False):
    fn = _swiglu.swiglu_plain if plain else _swiglu.swiglu
    return fn(g, u)
