"""Flash attention over ``[B, S, H, D]``, forward and backward: CUDA
kernels, plain versions and the autograd Function.

Forward: replaces ``paddle_tpu/ops/kernels/flash_attention_pallas.py``
``_fwd_common`` (:124-182; kernel body ``_attn_kernel`` :26-96), reached
through ``flash_attention_forward`` (:200) and
``flash_attention_forward_lse`` (:187). Source:
``paddle_tpu_torch/csrc/flash_attention.cu``.

Backward: replaces ``flash_attention_backward`` (:340-452: ``_dq_kernel``
at :397, ``_dkv_kernel`` at :418, delta = rowsum(dO * O) at :368-370).
Source: ``paddle_tpu_torch/csrc/flash_attention_bwd.cu``. One wrapper call,
:func:`flash_attention_bwd`, launches delta, dq and dk/dv (three kernels)
and counts as one launch. The dk/dv kernel loops over all ``H // Hkv``
query heads of a kv head, so the GQA group sum is made in f32 registers;
the TPU version writes per-query-head f32 partials and sums them after.
:class:`FlashAttentionFunction` is the counterpart of the custom_vjps of
``paddle_tpu/ops/kernels/flash_attention.py`` (``_flash_causal`` /
``_flash_full`` :78-130, ``_flash_seg_*`` :155-210): its forward is the
kernel with the log-sum-exp, its backward the kernels above. Where the
JAX ``_flash_impl`` / ``_bwd_impl`` catch a failed kernel and run the
composite, nothing here catches: a CUDA tensor launches or raises.

``k``/``v`` may carry ``Hkv`` heads with ``H % Hkv == 0``; query head ``h``
reads kv head ``h // (H // Hkv)`` by index (``_kv_index_map`` :99-109), and
nothing repeats the kv heads in memory. Options: causal or full attention,
``segment_ids [B, S]`` (a query sees only keys of its own segment; causal
applies inside), and the log-sum-exp, returned as ``[B*H, S]`` f32.

Numerics, in the kernel and the plain version alike: q scaled by
``1/sqrt(D)`` in f32, logits and probabilities in f32, masked logits
``-1e30`` (not ``-inf``) and masked probabilities exactly 0, so a query with
no visible key gives 0 (:70-75); the denominator clamped at ``1e-30``; the
output cast to q's dtype once. The plain version does not follow
``flash_attention.py`` ``_reference_attention``, which casts the
probabilities to q's dtype before ``P V``; in f32 the two agree.

The TPU kernel needs ``S`` to be a multiple of its block; this kernel takes
any ``S``. What bounds it on the H100: bf16 tensor-core operations at the
serving path's lengths (``4 * B * H * S^2 * D`` over two, causal). The CUDA
source describes the design; its one deviation from f32 is in ``P V``,
where the probabilities keep 16 significant bits (a two-term bf16 split)
instead of 24.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_plain",
           "flash_attention_forward", "flash_attention_forward_lse",
           "flash_attention_bwd", "flash_attention_bwd_plain",
           "FlashAttentionFunction"]

NEG_INF = -1e30
_HEAD_DIMS = (64, 128)
_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                       ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                            ctypes.c_void_p]


def _check(q, k, v, segment_ids):
    if not q.is_floating_point() or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention takes q, k, v of one floating "
                        f"dtype, got {q.dtype} / {k.dtype} / {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash attention takes q [B, S, H, D] and k, v "
                         f"[B, S, Hkv, D]; got {tuple(q.shape)} / "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d \
            or h % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}"
                         f" (same B, S, D; H % Hkv == 0)")
    if segment_ids is not None:
        if segment_ids.shape != (b, s) or segment_ids.dtype != torch.int32:
            raise ValueError(f"segment_ids must be int32 [{b}, {s}], got "
                             f"{segment_ids.dtype} {tuple(segment_ids.shape)}")
    if any(t is not None and t.device != q.device
           for t in (k, v, segment_ids)):
        raise ValueError("flash attention: operands on different devices")


def flash_attention_plain(q, k, v, causal=False, segment_ids=None,
                          with_lse=False):
    """The same function in plain PyTorch with the kernel's numerics
    (one softmax over the whole row instead of the online one). Returns
    ``out`` or ``(out, lse)``."""
    _check(q, k, v, segment_ids)
    b, s, h, d = q.shape
    h_kv = k.shape[2]
    rep = h // h_kv
    qg = (q.float() * np.float32(1.0 / math.sqrt(d))).reshape(
        b, s, h_kv, rep, d)
    logits = torch.einsum("bsgrd,btgd->bgrst", qg, k.float())
    valid = None
    if causal:
        valid = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    if segment_ids is not None:
        same = (segment_ids[:, :, None] == segment_ids[:, None, :])[
            :, None, None]                                   # [B,1,1,S,T]
        valid = same if valid is None else (valid & same)
    if valid is not None:
        logits = logits.masked_fill(~valid, NEG_INF)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    if valid is not None:
        p = p.masked_fill(~valid, 0.0)
    l_safe = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bgrst,btgd->bgrsd", p, v.float()) / l_safe
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)
    if not with_lse:
        return out
    lse = (m + torch.log(l_safe))[..., 0].reshape(b * h, s)
    return out, lse


def flash_attention(q, k, v, causal=False, segment_ids=None, with_lse=False):
    """Attention of ``q [B, S, H, D]`` over ``k``/``v [B, S, Hkv, D]``.
    Returns ``out [B, S, H, D]``, or ``(out, lse [B*H, S] f32)`` with
    ``with_lse``. A CPU tensor takes :func:`flash_attention_plain`; a CUDA
    tensor launches the kernel (bf16, contiguous, D in {64, 128}) or
    raises."""
    _check(q, k, v, segment_ids)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, segment_ids, with_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention: no kernel for device {q.device}")
    b, s, h, d = q.shape
    if q.dtype != torch.bfloat16:
        raise TypeError(f"flash attention kernel takes bf16, got {q.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes D in {_HEAD_DIMS}, "
                         f"got {d}")
    if b * h > 65535:
        raise ValueError(f"flash attention kernel takes B*H <= 65535, got "
                         f"{b * h}")
    ops = [t for t in (q, k, v, segment_ids) if t is not None]
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("flash attention kernel takes contiguous tensors")
    _build.require_aligned("flash_attention", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty(b * h, s, dtype=torch.float32, device=q.device) \
        if with_lse else None
    fn = _build.function("flash_attention", "ptt_flash_attention", _ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             None if segment_ids is None else segment_ids.data_ptr(),
             out.data_ptr(), None if lse is None else lse.data_ptr(),
             b, s, h, k.shape[2], d, int(bool(causal)),
             float(1.0 / math.sqrt(d)), _build.stream_of(q))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return (out, lse) if with_lse else out


flash_attention.launches = 0


def flash_attention_forward(q, k, v, causal=False, segment_ids=None,
                            plain=False):
    """Primal-only forward (``flash_attention_pallas.flash_attention_forward``)."""
    fn = flash_attention_plain if plain else flash_attention
    return fn(q, k, v, causal, segment_ids, False)


def flash_attention_forward_lse(q, k, v, causal=False, segment_ids=None,
                                plain=False):
    """``(out, lse [B*H, S] f32)``
    (``flash_attention_pallas.flash_attention_forward_lse``)."""
    fn = flash_attention_plain if plain else flash_attention
    return fn(q, k, v, causal, segment_ids, True)


def _check_bwd(q, k, v, out, lse, do, segment_ids):
    _check(q, k, v, segment_ids)
    b, s, h, _ = q.shape
    for name, t in (("out", out), ("dO", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash attention backward: {name} {t.dtype} "
                             f"{tuple(t.shape)} must match q {q.dtype} "
                             f"{tuple(q.shape)} on {q.device}")
    if lse.shape != (b * h, s) or lse.dtype != torch.float32 \
            or lse.device != q.device:
        raise ValueError(f"flash attention backward: lse must be f32 "
                         f"[{b * h}, {s}] on {q.device}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")


def _valid_mask(s, causal, segment_ids, device):
    """[B or 1, 1, 1, S, S] bool of visible (query, key) pairs, or None."""
    valid = None
    if causal:
        valid = torch.ones(s, s, dtype=torch.bool, device=device).tril()
    if segment_ids is not None:
        same = (segment_ids[:, :, None] == segment_ids[:, None, :])[
            :, None, None]
        valid = same if valid is None else (valid & same)
    return valid


def flash_attention_bwd_plain(q, k, v, out, lse, do, causal=False,
                              segment_ids=None):
    """``(dq, dk, dv)`` in plain PyTorch, f32 inside, from the forward's
    ``out`` and ``lse [B*H, S]``: P recomputed as ``exp(scale * q k - lse)``
    (0 where masked), ``dS = P * (dO v - delta)`` with ``delta =
    rowsum(dO * out)``; dk and dv summed over each kv head's query group
    before the one rounding."""
    _check_bwd(q, k, v, out, lse, do, segment_ids)
    b, s, h, d = q.shape
    h_kv = k.shape[2]
    rep = h // h_kv
    scale = np.float32(1.0 / math.sqrt(d))

    def grouped(t):                                  # [B, Hkv, rep, S, D]
        return t.float().reshape(b, s, h_kv, rep, d).permute(0, 2, 3, 1, 4)

    qg, dog, og = grouped(q), grouped(do), grouped(out)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]   # [B, Hkv, 1, S, D]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    logits = torch.einsum("bgrsd,bgrtd->bgrst", qg, kf) * scale
    p = torch.exp(logits - lse.reshape(b, h_kv, rep, s, 1))
    valid = _valid_mask(s, causal, segment_ids, q.device)
    if valid is not None:
        p = p.masked_fill(~valid, 0.0)
    delta = (dog * og).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bgrsd,bgrtd->bgrst", dog, vf) - delta)
    dq = torch.einsum("bgrst,bgrtd->bgrsd", ds, kf) * scale
    dk = torch.einsum("bgrst,bgrsd->bgtd", ds, qg) * scale
    dv = torch.einsum("bgrst,bgrsd->bgtd", p, dog)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)
    return (dq, dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def flash_attention_bwd(q, k, v, out, lse, do, causal=False,
                        segment_ids=None):
    """``(dq [B, S, H, D], dk, dv [B, S, Hkv, D])``, as
    :func:`flash_attention_bwd_plain`. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernels (bf16, contiguous, D in
    {64, 128}) or raises."""
    _check_bwd(q, k, v, out, lse, do, segment_ids)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, do, causal,
                                         segment_ids)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention backward: no kernel for device "
                         f"{q.device}")
    b, s, h, d = q.shape
    h_kv = k.shape[2]
    if q.dtype != torch.bfloat16:
        raise TypeError(f"flash attention backward kernel takes bf16, got "
                        f"{q.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash attention backward kernel takes D in "
                         f"{_HEAD_DIMS}, got {d}")
    if b * h > 65535:
        raise ValueError(f"flash attention backward kernel takes B*H <= "
                         f"65535, got {b * h}")
    ops = [t for t in (q, k, v, out, lse, do, segment_ids) if t is not None]
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("flash attention backward kernel takes contiguous "
                         "tensors")
    _build.require_aligned("flash_attention backward", q, k, v, out, do)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(b * h, s, dtype=torch.float32, device=q.device)
    fn = _build.function("flash_attention_bwd", "ptt_flash_attention_bwd",
                         _BWD_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             do.data_ptr(), lse.data_ptr(),
             None if segment_ids is None else segment_ids.data_ptr(),
             delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             b, s, h, h_kv, d, int(bool(causal)), float(1.0 / math.sqrt(d)),
             _build.stream_of(q))
    _build.check(err, "flash_attention backward")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with its backward kernels: ``apply(q, k, v, causal,
    segment_ids, plain)`` returns ``out``; the forward keeps the
    log-sum-exp for the backward. ``plain`` runs the plain forward and the
    plain backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, segment_ids, plain):
        fwd = flash_attention_plain if plain else flash_attention
        out, lse = fwd(q, k, v, causal, segment_ids, True)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids)
        ctx.causal, ctx.plain = causal, plain
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, seg = ctx.saved_tensors
        bwd = flash_attention_bwd_plain if ctx.plain else flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, out, lse, do.contiguous(), ctx.causal, seg)
        return dq, dk, dv, None, None, None
