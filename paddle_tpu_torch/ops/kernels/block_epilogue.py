"""Transformer-block epilogue ``act -> dropout -> + residual -> norm``: CUDA
kernel and plain version.

Replaces ``paddle_tpu/ops/kernels/block_fused_pallas.py`` ``_fwd`` (:212;
kernel body ``_fwd_kernel`` :118-150), with its faces ``attn_epilogue``,
``mlp_epilogue`` and ``decode_epilogue`` (:410-433). Source:
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
version and the TPU kernel drop the same elements, bit for bit.

What bounds it on the H100: bytes — ``x`` and ``residual`` read once, ``y``
and ``h`` written once, a few dozen operations per element. The kernel
gives each row one block of 16-byte vectors and keeps the f32 pre-norm row
in shared memory between the statistics pass and the output pass.

Unlike the JAX dispatch, which sends arrays under 512 elements to its
composite (``use_kernel``, :436-448), the wrapper launches the kernel for
every shape on the card.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _build

__all__ = ["fused_epilogue", "fused_epilogue_plain", "attn_epilogue",
           "mlp_epilogue", "decode_epilogue", "keep_mask", "dropout_params",
           "VALID_ACTS", "VALID_NORMS"]

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


def _check(x, residual, weight, bias, act, norm):
    if act not in VALID_ACTS:
        raise ValueError(f"act must be one of {VALID_ACTS}, got {act!r}")
    if norm not in VALID_NORMS:
        raise ValueError(f"norm must be one of {VALID_NORMS}, got {norm!r}")
    if norm == "rms" and bias is not None:
        raise ValueError("rms norm takes no bias")
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
        u = _GELU_K * (xf + _GELU_C * xf * xf * xf)
        z = 0.5 * xf * (1.0 + torch.tanh(u))
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
