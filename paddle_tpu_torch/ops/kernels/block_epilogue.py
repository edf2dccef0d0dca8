"""Transformer-block epilogue ``act -> dropout -> + residual -> norm``:
CUDA kernels (forward and backward), plain versions and the autograd
Function.

Replaces ``paddle_tpu/ops/kernels/block_fused_pallas.py`` ``_fwd`` (:212;
kernel body ``_fwd_kernel`` :118-150) and ``_bwd`` (:252; kernel body
``_bwd_kernel`` :153-209), with the custom_vjp ``fused_epilogue``
(:349-405) and its faces ``attn_epilogue``, ``mlp_epilogue`` and
``decode_epilogue`` (:410-433). Source:
``paddle_tpu_torch/csrc/block_epilogue.cu``.

Per row of the ``[N, H]`` output::

    z = act(x)                 None | "gelu" (tanh form) | "swiglu" (x [N, 2H])
    z = keep ? z * scale : 0   counter-hash dropout, 0 < p < 1 only
    h = z + residual
    y = norm(h) * w (+ b)      "rms" | "layer", f32 statistics

and returns ``(y, h)`` in the residual's dtype. The dropout mask is
murmur3's 32-bit finalizer over the global flat index of the ``[N, H]``
output, ``fmix32(idx ^ seed * 0x9E3779B9)``, kept where it is ``>=
threshold`` (``paddle_tpu/ops/kernels/dropout_add_pallas.py:57-74,
135-138``). It is a function of the data alone, so the kernel, the plain
version and the TPU kernel drop the same elements, bit for bit, and the
backward regenerates the forward's mask from the seed.

The backward takes the saved ``h`` (and ``x`` when ``act`` is set), the
cotangent ``gy`` of ``y`` and, optionally, ``gh`` of ``h``; it recomputes
the norm statistics from ``h`` in f32 and returns ``dx`` (x's shape and
dtype), ``dres = dh`` (h's dtype) and f32 ``dw = sum gy * xhat`` and ``db
= sum gy``. The kernel writes one f32 partial row of ``dw``/``db`` per
block of rows, which the wrapper sums, as JAX sums its per-block partials
outside its kernel (:303-304).

What bounds both on the H100: bytes — each input row read once, each
output written once, a few dozen operations per element. The forward
gives each row one block of 16-byte vectors and keeps the f32 pre-norm
row in shared memory between the statistics pass and the output pass; the
backward gives each block a strip of rows, keeps ``h`` and ``gy`` of the
row in shared memory the same way, and its partial ``dw``/``db`` there.

Unlike the JAX dispatch, which sends arrays under 512 elements to its
composite (``use_kernel``, :436-448), the wrappers launch the kernels for
every shape on the card.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _build

__all__ = ["fused_epilogue", "fused_epilogue_plain", "fused_epilogue_bwd",
           "fused_epilogue_bwd_plain", "BlockEpilogueFunction",
           "attn_epilogue", "mlp_epilogue", "decode_epilogue", "keep_mask",
           "dropout_params", "VALID_ACTS", "VALID_NORMS"]

VALID_ACTS = (None, "gelu", "swiglu")
VALID_NORMS = ("rms", "layer")

#: sqrt(2/pi) and the cubic coefficient of the tanh gelu approximation
_GELU_K = 0.7978845608028654
_GELU_C = 0.044715
_GOLDEN = 0x9E3779B9
_MASK32 = 0xFFFFFFFF
_ACT_CODE = {None: 0, "gelu": 1, "swiglu": 2}

_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_uint, ctypes.c_uint, ctypes.c_float,
    ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_uint, ctypes.c_uint, ctypes.c_float,
    ctypes.c_void_p]
#: backward: blocks of rows to fill the H100's 132 SMs with 2048 threads
#: each (at least four blocks an SM)
_SMS, _SM_THREADS = 132, 2048
#: shared memory a backward block may take (of 227 KB), less the static part
_BWD_SMEM = 227 * 1024 - 1024


def dropout_params(p: float):
    """``(threshold, scale)`` for drop probability ``p``
    (``dropout_add_pallas._params``)."""
    threshold = min(int(p * 4294967296.0), 4294967295)
    return threshold, 1.0 / (1.0 - p)


def _mul32(a, c: int):
    """``a * c mod 2**32`` for an int64 tensor ``a`` in ``[0, 2**32)``,
    split so that no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK32


def _fmix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def keep_mask(n_rows: int, hidden: int, seed: int, p: float, device="cpu"):
    """Bool ``[n_rows, hidden]``: the elements the counter-hash dropout
    keeps (uint32 arithmetic carried in int64)."""
    threshold, _ = dropout_params(p)
    idx = torch.arange(n_rows * hidden, dtype=torch.int64,
                       device=device) & _MASK32
    key = ((int(seed) & _MASK32) * _GOLDEN) & _MASK32
    bits = _fmix32(idx ^ key)
    return (bits >= threshold).reshape(n_rows, hidden)


def _gelu_tanh(xf):
    u = _GELU_K * (xf + _GELU_C * xf * xf * xf)
    return 0.5 * xf * (1.0 + torch.tanh(u))


def _gelu_tanh_grad(xf):
    """d gelu_tanh / dx (``block_fused_pallas._gelu_tanh_grad``, :85-90)."""
    t = torch.tanh(_GELU_K * (xf + _GELU_C * xf * xf * xf))
    du = _GELU_K * (1.0 + 3.0 * _GELU_C * xf * xf)
    return 0.5 * (1.0 + t) + 0.5 * xf * (1.0 - t * t) * du


def _check_options(act, norm, has_bias):
    if act not in VALID_ACTS:
        raise ValueError(f"act must be one of {VALID_ACTS}, got {act!r}")
    if norm not in VALID_NORMS:
        raise ValueError(f"norm must be one of {VALID_NORMS}, got {norm!r}")
    if norm == "rms" and has_bias:
        raise ValueError("rms norm takes no bias")


def _check(x, residual, weight, bias, act, norm):
    _check_options(act, norm, bias is not None)
    if not (x.is_floating_point() and residual.is_floating_point()):
        raise TypeError(f"block epilogue takes floating tensors, got "
                        f"{x.dtype} / {residual.dtype}")
    hd = residual.shape[-1]
    xw = hd * (2 if act == "swiglu" else 1)
    if x.dim() != residual.dim() or x.shape[:-1] != residual.shape[:-1] \
            or x.shape[-1] != xw:
        raise ValueError(f"act={act!r} expects x [..., {xw}] beside residual "
                         f"{tuple(residual.shape)}, got {tuple(x.shape)}")
    for t in (weight, bias):
        if t is not None and t.shape != (hd,):
            raise ValueError(f"norm weight/bias must be [{hd}], got "
                             f"{tuple(t.shape)}")
    if any(t is not None and t.device != x.device
           for t in (residual, weight, bias)):
        raise ValueError("block epilogue: operands on different devices")


def fused_epilogue_plain(x, residual, weight, bias=None, seed=0, p=0.0,
                         eps=1e-6, act=None, norm="rms"):
    """The same function in plain PyTorch, f32 inside
    (``block_fused_pallas.reference_fused_epilogue``, :453-490)."""
    _check(x, residual, weight, bias, act, norm)
    shp = residual.shape
    hd = shp[-1]
    n = math.prod(shp[:-1])
    xf = x.reshape(n, -1).float()
    if act == "gelu":
        z = _gelu_tanh(xf)
    elif act == "swiglu":
        g, up = xf[:, :hd], xf[:, hd:]
        z = g * torch.sigmoid(g) * up
    else:
        z = xf
    if 0.0 < p < 1.0:
        _, scale = dropout_params(p)
        keep = keep_mask(n, hd, seed, p, x.device)
        z = torch.where(keep, z * np.float32(scale), 0.0)
    h = z + residual.reshape(n, hd).float()
    w = weight.float()
    if norm == "rms":
        y = h * torch.rsqrt(h.square().mean(-1, keepdim=True) + eps) * w
    else:
        mu = h.mean(-1, keepdim=True)
        var = (h - mu).square().mean(-1, keepdim=True)
        y = (h - mu) * torch.rsqrt(var + eps) * w
    if bias is not None:
        y = y + bias.float()
    dt = residual.dtype
    return y.to(dt).reshape(shp), h.to(dt).reshape(shp)


def fused_epilogue(x, residual, weight, bias=None, seed=0, p=0.0, eps=1e-6,
                   act=None, norm="rms"):
    """``(y, h)``: ``y = norm(dropout(act(x)) + residual) * w (+ b)``, ``h``
    the pre-norm sum, both in the residual's dtype. ``seed`` (an int32)
    keys the dropout mask; it is read only when ``0 < p < 1``. A CPU
    tensor takes :func:`fused_epilogue_plain`; a CUDA tensor launches the
    kernel (bf16, contiguous, hidden % 8 == 0) or raises."""
    _check(x, residual, weight, bias, act, norm)
    if x.device.type == "cpu":
        return fused_epilogue_plain(x, residual, weight, bias, seed, p, eps,
                                    act, norm)
    if x.device.type != "cuda":
        raise ValueError(f"block epilogue: no kernel for device {x.device}")
    ops = [t for t in (x, residual, weight, bias) if t is not None]
    if any(t.dtype != torch.bfloat16 for t in ops):
        raise TypeError(f"block epilogue kernel takes bf16, got "
                        f"{[str(t.dtype) for t in ops]}")
    hd = residual.shape[-1]
    if hd % 8:
        raise ValueError(f"block epilogue kernel needs hidden % 8 == 0, got "
                         f"{hd}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("block epilogue kernel takes contiguous tensors")
    _build.require_aligned("block_epilogue", *ops)
    drop = 0.0 < p < 1.0
    threshold, scale = dropout_params(p) if drop else (0, 1.0)
    y = torch.empty_like(residual)
    h = torch.empty_like(residual)
    fn = _build.function("block_epilogue", "ptt_block_epilogue", _ARGS)
    err = fn(x.data_ptr(), residual.data_ptr(), weight.data_ptr(),
             None if bias is None else bias.data_ptr(), y.data_ptr(),
             h.data_ptr(), residual.numel() // hd, hd, _ACT_CODE[act],
             int(norm == "layer"), int(drop), float(eps),
             int(seed) & _MASK32, threshold, float(scale),
             _build.stream_of(x))
    _build.check(err, "block_epilogue")
    fused_epilogue.launches += 1
    return y, h


fused_epilogue.launches = 0


def _check_bwd(h, x, weight, gy, gh, act, norm, has_bias):
    _check_options(act, norm, has_bias)
    if (x is None) != (act is None):
        raise ValueError(f"the backward takes the saved x exactly when act "
                         f"is set (act={act!r})")
    hd = h.shape[-1]
    if weight.shape != (hd,):
        raise ValueError(f"norm weight must be [{hd}], got "
                         f"{tuple(weight.shape)}")
    for t in (gy, gh):
        if t is not None and (t.shape != h.shape or t.dtype != h.dtype):
            raise ValueError(f"cotangent {t.dtype} {tuple(t.shape)} must "
                             f"match h {h.dtype} {tuple(h.shape)}")
    if x is not None:
        xw = hd * (2 if act == "swiglu" else 1)
        if x.shape[:-1] != h.shape[:-1] or x.shape[-1] != xw:
            raise ValueError(f"act={act!r} expects x [..., {xw}] beside h "
                             f"{tuple(h.shape)}, got {tuple(x.shape)}")
    if any(t is not None and t.device != h.device
           for t in (x, weight, gy, gh)):
        raise ValueError("block epilogue backward: operands on different "
                         "devices")


def fused_epilogue_bwd_plain(h, x, weight, gy, gh=None, seed=0, p=0.0,
                             eps=1e-6, act=None, norm="rms", has_bias=False,
                             x_dtype=None):
    """The backward in plain PyTorch, f32 inside (the formulas of
    ``_bwd_kernel``, :153-209): ``(dx, dres, dw, db)`` for the saved
    ``h``, ``x`` (None when ``act`` is None) and the cotangents ``gy`` of
    ``y`` and ``gh`` of ``h`` (or None). ``dx`` has x's shape and dtype
    (``x_dtype``, default h's, when there is no x), ``dres`` h's dtype;
    ``dw`` and ``db`` (None unless ``has_bias``) are f32."""
    _check_bwd(h, x, weight, gy, gh, act, norm, has_bias)
    shp = h.shape
    hd = shp[-1]
    n = math.prod(shp[:-1])
    hf = h.reshape(n, hd).float()
    gyf = gy.reshape(n, hd).float()
    u = gyf * weight.float()
    if norm == "rms":
        rstd = torch.rsqrt(hf.square().mean(-1, keepdim=True) + eps)
        xhat = hf * rstd
        dot = (hf * u).sum(-1, keepdim=True)
        dh = rstd * u - hf * (rstd * rstd * rstd) * (dot * (1.0 / hd))
    else:
        mu = hf.mean(-1, keepdim=True)
        rstd = torch.rsqrt((hf - mu).square().mean(-1, keepdim=True) + eps)
        xhat = (hf - mu) * rstd
        c1 = u.mean(-1, keepdim=True)
        c2 = (u * xhat).mean(-1, keepdim=True)
        dh = (u - c1 - xhat * c2) * rstd
    dw = (gyf * xhat).sum(0)
    db = gyf.sum(0) if has_bias else None
    if gh is not None:
        dh = dh + gh.reshape(n, hd).float()
    dres = dh.to(h.dtype).reshape(shp)
    dz = dh
    if 0.0 < p < 1.0:
        _, scale = dropout_params(p)
        keep = keep_mask(n, hd, seed, p, h.device)
        dz = torch.where(keep, dz * np.float32(scale), 0.0)
    if act == "gelu":
        dx = dz * _gelu_tanh_grad(x.reshape(n, hd).float())
    elif act == "swiglu":
        xf = x.reshape(n, 2 * hd).float()
        g, up = xf[:, :hd], xf[:, hd:]
        sig = torch.sigmoid(g)
        sv = g * sig
        dx = torch.cat([dz * up * sig * (1.0 + g - sv), dz * sv], dim=-1)
    else:
        dx = dz
    if x is not None:
        return dx.to(x.dtype).reshape(x.shape), dres, dw, db
    return dx.to(x_dtype or h.dtype).reshape(shp), dres, dw, db


def fused_epilogue_bwd(h, x, weight, gy, gh=None, seed=0, p=0.0, eps=1e-6,
                       act=None, norm="rms", has_bias=False, x_dtype=None):
    """``(dx, dres, dw, db)``, as :func:`fused_epilogue_bwd_plain`. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel
    (bf16, contiguous, hidden % 8 == 0, and ``(3 + has_bias) * hidden``
    f32 in a block's shared memory) or raises."""
    _check_bwd(h, x, weight, gy, gh, act, norm, has_bias)
    if h.device.type == "cpu":
        return fused_epilogue_bwd_plain(h, x, weight, gy, gh, seed, p, eps,
                                        act, norm, has_bias, x_dtype)
    if h.device.type != "cuda":
        raise ValueError(f"block epilogue backward: no kernel for device "
                         f"{h.device}")
    ops = [t for t in (h, x, weight, gy, gh) if t is not None]
    if any(t.dtype != torch.bfloat16 for t in ops) or \
            (x_dtype is not None and x_dtype != torch.bfloat16):
        raise TypeError(f"block epilogue backward kernel takes bf16, got "
                        f"{[str(t.dtype) for t in ops]}")
    hd = h.shape[-1]
    smem = (3 + bool(has_bias)) * hd * 4
    if hd % 8 or smem > _BWD_SMEM:
        raise ValueError(f"block epilogue backward kernel needs hidden % 8 "
                         f"== 0 and {smem} <= {_BWD_SMEM} bytes of shared "
                         f"memory, got hidden {hd}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("block epilogue backward kernel takes contiguous "
                         "tensors")
    _build.require_aligned("block epilogue backward", *ops)
    rows = h.numel() // hd
    threads = min(1024, max(32, -(-hd // 256) * 32))   # the kernel's choice
    n_blocks = _SMS * max(4, _SM_THREADS // threads)
    per_block = max(1, -(-rows // n_blocks))
    n_part = max(1, -(-rows // per_block))
    drop = 0.0 < p < 1.0
    threshold, scale = dropout_params(p) if drop else (0, 1.0)
    dx = torch.empty_like(h if x is None else x)
    dres = torch.empty_like(h)
    # every block writes its whole partial row; no rows, no block
    part = torch.zeros if rows == 0 else torch.empty
    dw_part = part(n_part, hd, dtype=torch.float32, device=h.device)
    db_part = part(n_part, hd, dtype=torch.float32, device=h.device) \
        if has_bias else None
    fn = _build.function("block_epilogue", "ptt_block_epilogue_bwd",
                         _BWD_ARGS)
    err = fn(h.data_ptr(), None if x is None else x.data_ptr(),
             weight.data_ptr(), gy.data_ptr(),
             None if gh is None else gh.data_ptr(), dx.data_ptr(),
             dres.data_ptr(), dw_part.data_ptr(),
             None if db_part is None else db_part.data_ptr(), rows,
             per_block, hd, _ACT_CODE[act], int(norm == "layer"),
             int(bool(has_bias)), int(drop), float(eps),
             int(seed) & _MASK32, threshold, float(scale),
             _build.stream_of(h))
    _build.check(err, "block_epilogue backward")
    fused_epilogue_bwd.launches += 1
    return (dx, dres, dw_part.sum(0),
            None if db_part is None else db_part.sum(0))


fused_epilogue_bwd.launches = 0


class BlockEpilogueFunction(torch.autograd.Function):
    """The block epilogue with its backward kernel (the custom_vjp of
    ``fused_epilogue``, :349-405). ``apply(x, residual, weight, bias, seed,
    p, eps, act, norm, plain)`` returns ``(y, h)``; it saves ``h`` and,
    only when ``act`` is set, ``x`` (``_vjp_fwd``, :366-380). Both
    cotangents join the backward. ``plain`` runs the plain forward and the
    plain backward."""

    @staticmethod
    def forward(ctx, x, residual, weight, bias, seed, p, eps, act, norm,
                plain):
        fwd = fused_epilogue_plain if plain else fused_epilogue
        y, h = fwd(x, residual, weight, bias, seed, p, eps, act, norm)
        ctx.save_for_backward(h, x if act is not None else None, weight)
        ctx.args = (seed, p, eps, act, norm, bias is not None)
        ctx.x_dtype = x.dtype
        ctx.bias_dtype = None if bias is None else bias.dtype
        ctx.plain = plain
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, gy, gh):
        h, x, weight = ctx.saved_tensors
        if gy is None and gh is None:
            return (None,) * 10
        gy = torch.zeros_like(h) if gy is None else gy.contiguous()
        bwd = fused_epilogue_bwd_plain if ctx.plain else fused_epilogue_bwd
        dx, dres, dw, db = bwd(h, x, weight, gy,
                               None if gh is None else gh.contiguous(),
                               *ctx.args, x_dtype=ctx.x_dtype)
        return (dx, dres, dw.to(weight.dtype),
                None if db is None else db.to(ctx.bias_dtype),
                None, None, None, None, None, None)


def attn_epilogue(x, residual, weight, bias=None, seed=0, p=0.0, eps=1e-6,
                  norm="rms", plain=False):
    """Attention-output junction: ``dropout(x) + residual -> norm``."""
    fn = fused_epilogue_plain if plain else fused_epilogue
    return fn(x, residual, weight, bias, seed, p, eps, None, norm)


def mlp_epilogue(x, residual, weight, bias=None, seed=0, p=0.0, eps=1e-6,
                 act=None, norm="rms", plain=False):
    """FFN junction: ``act(x) -> dropout -> + residual -> norm``; ``act``
    None, "gelu" or "swiglu" (x packed ``[.., 2I]``)."""
    fn = fused_epilogue_plain if plain else fused_epilogue
    return fn(x, residual, weight, bias, seed, p, eps, act, norm)


def decode_epilogue(x, residual, weight, eps=1e-6, plain=False):
    """Serving junction (projection output -> residual add -> rmsnorm),
    dropout-free."""
    fn = fused_epilogue_plain if plain else fused_epilogue
    return fn(x, residual, weight, None, 0, 0.0, eps, None, "rms")
