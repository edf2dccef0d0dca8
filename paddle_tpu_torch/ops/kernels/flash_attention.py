"""Flash-attention forward over ``[B, S, H, D]``: CUDA kernel and plain
version.

Replaces ``paddle_tpu/ops/kernels/flash_attention_pallas.py`` ``_fwd_common``
(:124-182; kernel body ``_attn_kernel`` :26-96), reached through
``flash_attention_forward`` (:200) and ``flash_attention_forward_lse``
(:187). Source: ``paddle_tpu_torch/csrc/flash_attention.cu``.

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
           "flash_attention_forward", "flash_attention_forward_lse"]

NEG_INF = -1e30
_HEAD_DIMS = (64, 128)
_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float,
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
