"""Fused incubate operators (counterpart of
``paddle_tpu/incubate/operators.py``): the masked softmax of attention
scores that do not go through flash attention.

``softmax_mask_fuse(x, mask)`` and ``softmax_mask_fuse_upper_triangle(x)``
take scores ``x [B, H, Sq, Sk]`` through the masked-softmax kernels
(``ops/kernels/softmax_mask.py``), forward and backward; the causal
variant makes its triangle in the kernel (top-left corner, ``col <= q``).
Scores of another rank take the plain composite, as JAX's ``_use_kernel``
(:20-33) sends them there. ``plain=True`` runs the plain versions on any
device.
"""

from __future__ import annotations

from ..nn.functional import _needs_grad
from ..ops.kernels import softmax_mask as _sm

__all__ = ["softmax_mask_fuse", "softmax_mask_fuse_upper_triangle"]


def softmax_mask_fuse(x, mask, name=None, plain=False):
    """``softmax(x + mask)`` over the last axis, in f32 with one rounding
    to x's dtype; ``mask`` broadcasts to ``x``. A mask that requires grad
    gets ``dx`` summed onto its shape."""
    if x.dim() != 4:
        return _sm.softmax_mask_plain(x, mask)
    if _needs_grad(x, mask):
        return _sm.SoftmaxMaskFunction.apply(x, mask, plain)
    return (_sm.softmax_mask_plain if plain else _sm.softmax_mask)(x, mask)


def softmax_mask_fuse_upper_triangle(x, plain=False):
    """The causal softmax: entries with ``col > q`` are masked out before
    the row softmax (the triangle's corner at the top left)."""
    if x.dim() != 4:
        return _sm.softmax_mask_tri_plain(x)
    if _needs_grad(x):
        return _sm.SoftmaxMaskTriFunction.apply(x, plain)
    return (_sm.softmax_mask_tri_plain if plain else _sm.softmax_mask_tri)(x)
