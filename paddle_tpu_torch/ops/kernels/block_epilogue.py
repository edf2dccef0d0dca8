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
135-138``; the hash lives in ``dropout_add.py`` and ``csrc/common.cuh``,
shared with the dropout-add kernel). It is a function of the data alone,
so the kernel, the plain version and the TPU kernel drop the same
elements, bit for bit, and the backward regenerates the forward's mask
from the seed.

The backward takes the saved ``h`` (and ``x`` when ``act`` is set), the
cotangent ``gy`` of ``y`` and, optionally, ``gh`` of ``h``; it recomputes
the norm statistics from ``h`` in f32 and returns ``dx`` (x's shape and
dtype), ``dres = dh`` (h's dtype) and f32 ``dw = sum gy * xhat`` and ``db
= sum gy``. The rows kernel writes one f32 partial row of ``dw``/``db``
per block, and a second kernel of the same call adds them in a fixed order,
as JAX sums its per-block partials outside its kernel (:303-304).

What bounds both on the H100: bytes — each input row read once, each
output written once, a few dozen operations per element. The forward
holds a row in the registers of its block, a vector of 8 a thread, and
requests ``w``, ``b``, ``x`` and the residual before its first reduction,
so a row costs one memory round trip (layer norm's variance is a second
pass over the registers); :func:`plan` (``_norm_rows.plan``, shared with
the RMSNorm forward) keeps rows past 8192, and the variants with an
activation or dropout, on the shared-memory arm (the f32 row in shared
memory between the passes). The backward gives a row to a group of warps
that walks a strip of rows, brings its next rows of ``h``, ``gy`` and
``gh`` into shared memory by bulk copies while it works on the current one
(through hidden 8192),
reduces the statistics by shuffles (and the group's named barrier), and
keeps its partial ``dw``/``db`` in registers across the strip; the grid
fills the card once (:func:`_bwd_plan` mirrors the source's plan).

Unlike the JAX dispatch, which sends arrays under 512 elements to its
composite (``use_kernel``, :436-448), the wrappers launch the kernels for
every shape on the card.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from . import _norm_rows
from ._norm_rows import WIDE_HIDDEN
from .dropout_add import dropout_params, keep_mask

__all__ = ["fused_epilogue", "fused_epilogue_plain", "fused_epilogue_bwd",
           "fused_epilogue_bwd_plain", "BlockEpilogueFunction",
           "attn_epilogue", "mlp_epilogue", "decode_epilogue", "keep_mask",
           "dropout_params", "VALID_ACTS", "VALID_NORMS", "plan"]

VALID_ACTS = (None, "gelu", "swiglu")
VALID_NORMS = ("rms", "layer")

#: sqrt(2/pi) and the cubic coefficient of the tanh gelu approximation
_GELU_K = 0.7978845608028654
_GELU_C = 0.044715
_MASK32 = 0xFFFFFFFF
_ACT_CODE = {None: 0, "gelu": 1, "swiglu": 2}

# rows, hidden, act, layer, drop, eps, seed, threshold, scale, the plan's
# launch word, the stream
_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_uint, ctypes.c_uint, ctypes.c_float,
    ctypes.c_longlong, ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_uint, ctypes.c_uint, ctypes.c_float,
    ctypes.c_void_p]
#: the backward's plan (``bwd_plan`` in the source; the tests hold these
#: against its constants): the H100's SMs, narrow blocks an SM the grid is
#: sized for, warps of a narrow block, 16-byte vectors a lane holds
#: (narrow: hidden <= 8192; wide), warps of a wide group at most, partial
#: rows a column's threads split in the sum kernel
_SMS, _SMEM_SM, _MAX_THREADS, _BLOCK_WARPS = 132, 233472, 512, 8
_NARROW_VECS, _WIDE_VECS, _MAX_GROUP_WARPS, _STAGES, _SUM_ROWS = 2, 8, 16, 3, 8
#: the backward's contract: ``(3 + has_bias) * hidden`` f32 within this
#: many bytes (hidden <= 19280, 14464 with a bias)
_BWD_SMEM = 227 * 1024 - 1024


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
    kernel (bf16, contiguous, hidden % 8 == 0 and at most
    ``_norm_rows.WIDE_HIDDEN``) or raises."""
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
    if hd % 8 or hd > WIDE_HIDDEN:
        raise ValueError(f"block epilogue kernel needs hidden % 8 == 0 and "
                         f"hidden <= {WIDE_HIDDEN}, got {hd}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("block epilogue kernel takes contiguous tensors")
    _build.require_aligned("block_epilogue", *ops)
    y = torch.empty_like(residual)
    h = torch.empty_like(residual)
    _launch(x, residual, weight, bias, y, h, seed, p, eps, act, norm,
            _build.stream_of(x))
    fused_epilogue.launches += 1
    return y, h


fused_epilogue.launches = 0


def plan(rows, hidden, act=None, drop=False):
    """The forward's launch (``_norm_rows.plan``): a block a row in
    registers without an activation or dropout, else, as past 8192, the
    shared-memory arm."""
    return _norm_rows.plan(rows, hidden, act is None and not drop)


def _launch(x, residual, weight, bias, y, h, seed, p, eps, act, norm,
            stream):
    """The forward's C entry on operands the caller allocated, launched as
    :func:`plan` says."""
    hd = residual.shape[-1]
    rows = residual.numel() // hd
    drop = 0.0 < p < 1.0
    threshold, scale = dropout_params(p) if drop else (0, 1.0)
    fn = _build.function("block_epilogue", "ptt_block_epilogue", _ARGS)
    err = fn(x.data_ptr(), residual.data_ptr(), weight.data_ptr(),
             None if bias is None else bias.data_ptr(), y.data_ptr(),
             h.data_ptr(), rows, hd, _ACT_CODE[act], int(norm == "layer"),
             int(drop), float(eps), int(seed) & _MASK32, threshold,
             float(scale), plan(rows, hd, act, drop).word, stream)
    _build.check(err, "block_epilogue")


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
    tensor takes the plain version; a CUDA tensor launches the kernels
    (bf16, contiguous, hidden % 8 == 0, and ``(3 + has_bias) * hidden``
    f32 within ``_BWD_SMEM`` bytes) or raises. One call counts one
    launch."""
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
    nb = 1 + bool(has_bias)
    dx = torch.empty_like(h if x is None else x)
    dres = torch.empty_like(h)
    plan = _bwd_plan(rows, hd, has_bias, gh is not None)
    part = torch.empty(nb, plan.blocks, hd, dtype=torch.float32,
                       device=h.device)
    # the sum kernel writes every column; no rows, no launch
    out = (torch.zeros if rows == 0 else torch.empty)(
        nb, hd, dtype=torch.float32, device=h.device)
    _build.require_aligned("block epilogue backward", part, out)
    _launch_bwd(h, x, weight, gy, gh, dx, dres, part, out, seed, p, eps, act,
                norm, has_bias, _build.stream_of(h))
    fused_epilogue_bwd.launches += 1
    return dx, dres, out[0], out[1] if has_bias else None


fused_epilogue_bwd.launches = 0


class _BwdPlan(NamedTuple):
    vecs: int            # 16-byte vectors of a row a lane owns
    group_warps: int     # warps that own a row
    groups: int          # groups a block
    threads: int
    smem: int            # dynamic shared memory of the rows kernel
    blocks_sm: int       # blocks an SM the grid is sized for
    rows_per_group: int  # consecutive rows a group walks
    blocks: int          # partial rows


def _bwd_plan(rows, hd, has_bias, has_gh=True):
    """The backward's launch plan, as ``bwd_plan`` in the source: a group
    of ceil(hidden / 512) warps a row through hidden 8192 (2 vectors a
    lane; 8 / group warps groups a block), their rows staged in shared
    memory three at a time; above it ceil(hidden / 2048) warps a row (8
    vectors a lane); as many blocks an SM as shared memory and 128
    registers a thread allow; the strips sized so that the grid fills the
    card once."""
    vecs = hd // 8
    narrow = vecs <= _NARROW_VECS * 32 * _MAX_GROUP_WARPS
    v = _NARROW_VECS if narrow else _WIDE_VECS
    g = max(1, -(-vecs // (32 * v)))
    ng = max(1, _BLOCK_WARPS // g)
    threads = ng * g * 32
    na = 2 + bool(has_gh)
    smem = ng * _STAGES * (na * hd * 2 + 8) if narrow \
        else (2 if has_bias else 1) * hd * 4
    bsm = max(1, min(_SMEM_SM // (smem + 1024), 65536 // (128 * threads)))
    slots = _SMS * bsm * ng
    rpg = max(1, -(-rows // slots))
    blocks = max(1, -(-rows // (rpg * ng)))
    return _BwdPlan(v, g, ng, threads, smem, bsm, rpg, blocks)


def _launch_bwd(h, x, weight, gy, gh, dx, dres, part, out, seed, p, eps,
                act, norm, has_bias, stream):
    """The backward's C entry (the rows kernel, then the partial-sum
    kernel) on operands the caller allocated: ``part [1 + has_bias,
    blocks, hidden]`` f32 scratch and ``out [1 + has_bias, hidden]``, dw
    then db."""
    hd = h.shape[-1]
    rows = h.numel() // hd
    drop = 0.0 < p < 1.0
    threshold, scale = dropout_params(p) if drop else (0, 1.0)
    fn = _build.function("block_epilogue", "ptt_block_epilogue_bwd",
                         _BWD_ARGS)
    err = fn(h.data_ptr(), None if x is None else x.data_ptr(),
             weight.data_ptr(), gy.data_ptr(),
             None if gh is None else gh.data_ptr(), dx.data_ptr(),
             dres.data_ptr(), part.data_ptr(), out.data_ptr(), rows,
             part.shape[1], hd, _ACT_CODE[act], int(norm == "layer"),
             int(bool(has_bias)), int(drop), float(eps),
             int(seed) & _MASK32, threshold, float(scale), stream)
    _build.check(err, "block_epilogue backward")


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


# -- declared launches for the kernel analyzer -------------------------------

_ACT_FLOPS = {None: 0, "gelu": 9, "swiglu": 5}
#: phase 3's forward rows (rows, hidden, act, norm, p, bias): the decode
#: and prefill junctions, the Llama train step's, four functional rows, and
#: GPT-2 small's layer norm
FWD_SHAPES = ((8, 4096, None, "rms", 0.0, False),
              (1024, 4096, None, "rms", 0.0, False),
              (4096, 4096, None, "rms", 0.0, False),
              (512, 4096, "gelu", "rms", 0.0, False),
              (512, 4096, "swiglu", "rms", 0.0, False),
              (512, 4096, None, "rms", 0.1, False),
              (512, 4096, None, "layer", 0.0, True),
              (8192, 768, None, "layer", 0.0, True))
_ACT_BWD_FLOPS = {None: 0, "gelu": 16, "swiglu": 12}


def _targs(act, norm, bias, drop):
    b = ("true" if v else "false" for v in (norm == "layer", bias, drop))
    return f"<{_ACT_CODE[act]},{','.join(b)}>"


def _ex_fwd(label, rows, hidden, act, norm, p, bias):
    """The launch :func:`plan` gives: y and h rows written, x and the
    residual rows read by the blocks that take them, w (and b) whole."""
    from ._examples import model, normal
    from ._norm_rows import declare
    m = model()
    bf = torch.bfloat16
    xw = hidden * (2 if act == "swiglu" else 1)
    ops = [m.Operand("x", (rows, xw), bf), m.Operand("res", (rows, hidden), bf),
           m.Operand("w", (hidden,), bf, data=normal((hidden,), bf, 0.1, 1.0)),
           m.Operand("y", (rows, hidden), bf, "out"),
           m.Operand("h", (rows, hidden), bf, "out")]
    if bias:
        ops.append(m.Operand("b", (hidden,), bf, data=normal((hidden,), bf,
                                                             0.1)))
    args = (1234, p, 1e-5, act, norm)

    def plain(t):
        y, h = fused_epilogue_plain(t["x"], t["res"], t["w"], t.get("b"),
                                    *args)
        return {"y": y, "h": h}

    def launch(t, stream):
        _launch(t["x"], t["res"], t["w"], t.get("b"), t["y"], t["h"], *args,
                stream)

    kern = declare(m, "block_epilogue_kernel" + _targs(act, norm, bias,
                                                       0 < p < 1),
                   plan(rows, hidden, act, 0 < p < 1), rows, hidden,
                   [("y", hidden), ("h", hidden)],
                   [("x", xw), ("res", hidden)], ("w", "b") if bias else ("w",))
    n = rows * hidden
    flops = n * (6 + 3 * (norm == "layer") + bias + _ACT_FLOPS[act]
                 + 14 * (0 < p < 1))
    return m.Example(label, "block_epilogue", ops, [kern], launch, plain,
                     flops=flops, nbytes=declared_bytes(rows, hidden, act,
                                                        bias))


def declared_bytes(rows, hidden, act, bias):
    """The bytes a forward call must move, bf16: x ([rows, 2 hidden] for
    swiglu) and the residual read, y and h written, w (and b) read once."""
    xw = hidden * (2 if act == "swiglu" else 1)
    return 2 * (rows * xw + 3 * rows * hidden + hidden * (1 + bool(bias)))


def _ex_bwd(label, rows, hidden, act, norm, p, bias, with_gh=True):
    """The rows kernel (a group of warps a row, ``groups`` groups a block,
    each walking ``rows_per_group`` consecutive rows: dx and dres rows
    written, one f32 partial row of dw, and of db, a block), then the sum
    kernel (32 columns of [dw; db] a block)."""
    from ._examples import model, normal
    m = model()
    bf, f32 = torch.bfloat16, torch.float32
    xw = hidden * (2 if act == "swiglu" else 1)
    plan = _bwd_plan(rows, hidden, bias, with_gh)
    nb = 1 + bool(bias)
    per = plan.rows_per_group * plan.groups
    ops = [m.Operand("h", (rows, hidden), bf),
           m.Operand("w", (hidden,), bf, data=normal((hidden,), bf, 0.1, 1.0)),
           m.Operand("gy", (rows, hidden), bf),
           m.Operand("dx", (rows, xw), bf, "out"),
           m.Operand("dres", (rows, hidden), bf, "out"),
           m.Operand("part", (nb, plan.blocks, hidden), f32, "out"),
           m.Operand("out", (nb, hidden), f32, "out")]
    if act:
        ops.append(m.Operand("x", (rows, xw), bf))
    if with_gh:
        ops.append(m.Operand("gh", (rows, hidden), bf))
    args = (1234, p, 1e-5, act, norm, bias)

    def plain(t):
        dx, dres, dw, db = fused_epilogue_bwd_plain(
            t["h"], t.get("x"), t["w"], t["gy"], t.get("gh"), *args)
        sums = torch.stack([dw, db]) if bias else dw[None]
        return {"dx": dx, "dres": dres, "part": sums, "out": sums}

    def launch(t, stream):
        _launch_bwd(t["h"], t.get("x"), t["w"], t["gy"], t.get("gh"),
                    t["dx"], t["dres"], t["part"], t["out"], *args, stream)

    kernels = [
        m.KernelLaunch(
            "block_epilogue_bwd_rows_kernel"
            + _targs(act, norm, bias, 0 < p < 1)[:-1] + f",{plan.vecs}>",
            plan.blocks, plan.threads, smem=plan.smem,
            writes=[m.rows_map("dx", rows, xw, per),
                    m.rows_map("dres", rows, hidden, per),
                    m.TileMap("part", (1, 1, hidden), lambda x, y, z: [
                        (a, x, 0) for a in range(nb)])]),
        m.KernelLaunch("block_epilogue_bwd_sum_kernel",
                       -(-nb * hidden // 32), 32 * _SUM_ROWS,
                       writes=[m.TileMap("out", (32,), lambda x, y, z: (x,),
                                         view=(nb * hidden,))])]
    n = rows * hidden
    flops = n * (14 + 6 * (norm == "layer") + 2 * bias + 15 * (0 < p < 1)
                 + _ACT_BWD_FLOPS[act])
    nbytes = 2 * (4 * n + (2 * rows * xw if act else n) + hidden) \
        + 4 * hidden * (1 + bias)
    return m.Example(label, "block_epilogue", ops, kernels, launch, plain,
                     flops=flops, nbytes=nbytes,
                     tol={"part": 1e-3, "out": 1e-3, "*": 2.0 ** -7},
                     reduce={"part": lambda v: v.sum(1)})


def ck_examples():
    """At ``block_fused_pallas.pk_examples``' shapes (attention and SwiGLU
    junctions and the backward at [512, 1024]), the forward past 8192 (the
    wide arm), and phase 3's (the forward
    at :data:`FWD_SHAPES`: hidden 4096 at [8], [1024] and [4096] rows plain
    and [512] rows with gelu, swiglu, dropout 0.1 and layer norm with a
    bias, and GPT-2 small's [8192, 768] layer norm with a bias; the
    backward at
    Llama-3-8B's and GPT-2 small's junctions and two functional rows, and
    at hidden 12288, where a group of warps is the whole block); each with
    a tail of an odd row count and a hidden width that leaves threads of
    the last warp idle."""
    from ._examples import with_tail
    out = []
    fwd = [("attn_epilogue_fwd", 512, 1024, None, "rms", 0.0, False),
           ("mlp_swiglu_fwd", 512, 1024, "swiglu", "rms", 0.0, False),
           ("epilogue_fwd_wide", 37, 12288, "gelu", "layer", 0.1, True)]
    for rows, hid, act, norm, p, bias in FWD_SHAPES:
        fwd.append((f"phase3 [{rows}, {hid}] act={act} {norm} p={p}"
                    + (" bias" if bias else ""), rows, hid, act, norm, p,
                    bias))
    for label, rows, hidden, act, norm, p, bias in fwd:
        out.append(with_tail(
            _ex_fwd, label, dict(rows=rows, hidden=hidden, act=act,
                                 norm=norm, p=p, bias=bias),
            dict(rows=rows + 3, hidden=hidden + 8, act=act, norm=norm, p=p,
                 bias=bias)))
    bwd = [("epilogue_bwd", 512, 1024, None, "rms", 0.0, False, False),
           ("epilogue_bwd_wide", 37, 12288, "gelu", "layer", 0.1, True,
            True)]
    for rows, hidden, act, norm, p, bias in (
            (4096, 4096, None, "rms", 0.0, False),
            (8192, 768, None, "layer", 0.0, True),
            (4096, 4096, "gelu", "layer", 0.2, True),
            (4096, 4096, "swiglu", "rms", 0.4, False)):
        bwd.append((f"phase3 bwd [{rows}, {hidden}] act={act} {norm} p={p}"
                    + (" bias" if bias else ""), rows, hidden, act, norm, p,
                    bias, True))
    for label, rows, hidden, act, norm, p, bias, gh in bwd:
        out.append(with_tail(
            _ex_bwd, label, dict(rows=rows, hidden=hidden, act=act,
                                 norm=norm, p=p, bias=bias, with_gh=gh),
            dict(rows=1061 if hidden <= 8192 else 5, hidden=hidden + 8,
                 act=act, norm=norm, p=p, bias=bias, with_gh=gh)))
    return out
