"""One whole decode layer from the paged pool — attention, o_proj, the
attention junction, the SwiGLU MLP and the MLP junction — in one launch:
CUDA kernel and plain version.

Replaces ``paddle_tpu/ops/kernels/decode_layer_pallas.py`` ``_fwd`` (:201;
kernel body ``_decode_layer_kernel`` :75-183). Source:
``paddle_tpu_torch/csrc/decode_layer.cu``.

Per batch row, with every intermediate in f32 (the attention output,
``h1``, ``y1`` and ``z`` are never rounded)::

    o  = attention of q over positions 0..pos through the page table
    h1 = o @ wo^T + hres;          y1 = rmsnorm(h1) * w_post
    z  = silu(y1 @ wg^T) * (y1 @ wu^T)
    h2 = h1 + z @ wd^T;            y2 = rmsnorm(h2) * w_next

and returns ``(y2, h2)`` in the activation dtype: the next layer's normed
input and the residual stream. The weights are the port's ``nn.Linear``
``[out, in]`` tensors, passed as they are: for Llama-3-8B a transposed copy
would cost 12 GB of memory and 386 MB of extra traffic a layer.

What bounds it on the H100: bytes. At batch 8 one Llama-3-8B layer reads
386 MB of bf16 weights and ~25 MB of keys and values (~0.12 ms at
3.35 TB/s) for 3.1 GFLOP (0.046 ms in f32 on the CUDA cores). The TPU
kernel keeps the weights resident in VMEM and runs the layer tail in one
grid step per row; on the card that would stream all weights through one
SM per row. The kernel is one persistent cooperative launch instead, whose
five phases (attention; o_proj; norm, gate/up and SiLU; down; norm) each
spread over every SM, separated by grid-wide barriers. A warp streams 2
weight rows at a time in 16-byte loads, the next step's loads in flight
while it computes the current one, against up to 8 activation rows staged
in shared memory: each weight byte is read once per 8 batch rows (batch
9-16 streams the weights twice). Sums run in a fixed order, so two calls
on the same inputs give the same bits.

``block_i`` is the MLP's column chunk — here the unit in which the gate/up
columns are dealt to the blocks, in turn — and the one tuned knob
(``ops/kernels/autotune.py`` measures it and installs the winner under
:data:`BLOCK_I_KEY`). With nothing installed the kernel takes
:data:`DEFAULT_BLOCK_I` (clamped by the JAX rule), where the TPU kernel
takes the full width: one chunk would leave all but one SM idle here.

Unlike the JAX dispatch gate (``use_kernel``, :294-321), which sends
layers that do not fit half the VMEM — Llama-3-8B among them — to the
composite, :func:`use_kernel` checks only what the CUDA kernel takes.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, mmha

__all__ = ["decode_layer", "decode_layer_plain", "use_kernel",
           "unsupported_reason", "BLOCK_I_KEY", "DEFAULT_BLOCK_I", "PHASES",
           "MAX_BATCH", "set_block_override", "get_block_override"]

#: override-registry key of the MLP column chunk (the tuner's knob)
BLOCK_I_KEY = "decode_layer_i"
#: column chunk when no measured override is installed
DEFAULT_BLOCK_I = 64
#: largest batch the kernel takes
MAX_BATCH = 16
_HEAD_DIMS = (64, 128)
_REPS = (1, 2, 4, 8)

_ARGS = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 9 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
#: the kernel's phases, in order, as :func:`decode_layer`'s ``stamps``
#: delimit them
PHASES = ("attention", "o_proj", "gate_up", "down", "norm")

_BLOCK_OVERRIDES: dict = {}


def set_block_override(key, value) -> None:
    """Install a measured block size for a kernel family (``None``
    clears); a positive multiple of 8, as in the JAX registry."""
    if value is None:
        _BLOCK_OVERRIDES.pop(key, None)
        return
    if value % 8 or value <= 0:
        raise ValueError(f"block override must be a positive multiple of 8, "
                         f"got {value}")
    _BLOCK_OVERRIDES[key] = int(value)


def get_block_override(key):
    return _BLOCK_OVERRIDES.get(key)


def _pick_block_i(i_size):
    """MLP column chunk: the measured override when the tuner installed
    one, else :data:`DEFAULT_BLOCK_I`, clamped to a divisor of ``i_size``
    by the JAX rule (``decode_layer_pallas.py:186-195``)."""
    o = get_block_override(BLOCK_I_KEY)
    if o is None:
        o = DEFAULT_BLOCK_I
    o = min(int(o), i_size)
    while i_size % o:
        o -= 8
    return max(o, 8) if i_size % 8 == 0 else i_size


def unsupported_reason(q_shape, pool_shape, n_pages, hd, i_size,
                       dtype=torch.bfloat16):
    """Why the CUDA kernel does not take this shape, or ``None`` when it
    does. ``pool_shape`` is one layer's ``[P, Hkv, ps, D]``; ``n_pages``
    the page-table width; ``dtype`` the activations' and the pool's."""
    if len(q_shape) != 3 or len(pool_shape) != 4:
        return f"q {tuple(q_shape)} / pool {tuple(pool_shape)} ranks"
    b, h, d = q_shape
    _, h_kv, ps, d2 = pool_shape
    if d != d2 or h % h_kv:
        return f"q {tuple(q_shape)} does not fit pool {tuple(pool_shape)}"
    if d not in _HEAD_DIMS or h // h_kv not in _REPS:
        return (f"head_dim {d} (takes {_HEAD_DIMS}) / H/Hkv {h // h_kv} "
                f"(takes {_REPS})")
    if not 1 <= b <= MAX_BATCH:
        return f"batch {b} (takes 1..{MAX_BATCH})"
    if hd % 8 or i_size % 8 or ps < 1 or n_pages < 1:
        return (f"hidden {hd} / intermediate {i_size} not multiples of 8, or "
                f"page_size {ps} / pages {n_pages} < 1")
    if dtype != torch.bfloat16:
        return f"dtype {dtype} (takes bfloat16)"
    return None


def use_kernel(q_shape, pool_shape, n_pages, hd, i_size,
               dtype=torch.bfloat16) -> bool:
    """Whether the CUDA kernel takes this layer (no VMEM budget here: the
    kernel streams its weights from device memory)."""
    return unsupported_reason(q_shape, pool_shape, n_pages, hd, i_size,
                              dtype) is None


def _check(q, k_layer, v_layer, tables, pos, hres, wo, w_post, wg, wu, wd,
           w_next):
    if q.dim() != 3 or k_layer.dim() != 4 or k_layer.shape != v_layer.shape:
        raise ValueError(f"decode_layer: q {tuple(q.shape)} must be [B, H, D] "
                         f"and k/v [P, Hkv, ps, D], got "
                         f"{tuple(k_layer.shape)} / {tuple(v_layer.shape)}")
    b, h, d = q.shape
    h_kv = k_layer.shape[1]
    hd = hres.shape[-1]
    i_size = wg.shape[0]
    if k_layer.shape[3] != d or h % h_kv:
        raise ValueError(f"decode_layer: pool {tuple(k_layer.shape)} does "
                         f"not fit q {tuple(q.shape)}")
    if tables.dim() != 2 or tables.shape[0] != b or pos.shape != (b,) \
            or hres.shape != (b, hd):
        raise ValueError(f"decode_layer: tables {tuple(tables.shape)}, pos "
                         f"{tuple(pos.shape)}, hres {tuple(hres.shape)} do "
                         f"not fit batch {b}")
    want = {"wo": (hd, h * d), "wg": (i_size, hd), "wu": (i_size, hd),
            "wd": (hd, i_size), "w_post": (hd,), "w_next": (hd,)}
    got = {"wo": wo, "wg": wg, "wu": wu, "wd": wd, "w_post": w_post,
           "w_next": w_next}
    bad = [f"{n} {tuple(got[n].shape)} != {s}" for n, s in want.items()
           if tuple(got[n].shape) != s]
    if bad:
        raise ValueError(f"decode_layer: weights in [out, in] layout: "
                         f"{', '.join(bad)}")
    if tables.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("decode_layer: tables and pos must be int32")
    ops = (k_layer, v_layer, tables, pos, hres, wo, w_post, wg, wu, wd,
           w_next)
    if any(t.device != q.device for t in ops):
        raise ValueError("decode_layer: operands on different devices")


def decode_layer_plain(q, k_layer, v_layer, tables, pos, hres, wo, w_post,
                       wg, wu, wd, w_next, eps_post=1e-6, eps_next=1e-6,
                       block_i=None):
    """The same function in plain PyTorch (``reference_decode_layer``,
    :324-349): page-table gather, :func:`mmha.reference_mmha`, then f32
    matrix products and norms. ``block_i`` is a schedule knob and changes
    nothing here."""
    _check(q, k_layer, v_layer, tables, pos, hres, wo, w_post, wg, wu, wd,
           w_next)
    b, h, d = q.shape
    out = mmha.reference_mmha(q[:, None], mmha.gather_pages(k_layer, tables),
                              mmha.gather_pages(v_layer, tables), pos)
    attn = out.reshape(b, h * d).float() @ wo.float().t()
    h1 = attn + hres.float()
    y1 = h1 * torch.rsqrt(h1.square().mean(-1, keepdim=True) + eps_post) \
        * w_post.float()
    g = y1 @ wg.float().t()
    u = y1 @ wu.float().t()
    h2 = h1 + (g * torch.sigmoid(g) * u) @ wd.float().t()
    y2 = h2 * torch.rsqrt(h2.square().mean(-1, keepdim=True) + eps_next) \
        * w_next.float()
    return y2.to(hres.dtype), h2.to(hres.dtype)


def decode_layer(q, k_layer, v_layer, tables, pos, hres, wo, w_post, wg, wu,
                 wd, w_next, eps_post=1e-6, eps_next=1e-6, block_i=None,
                 stamps=None):
    """One whole decode layer, fused.

    q ``[B, H, D]`` (after RoPE, the layer's current token); k/v_layer
    ``[P, Hkv, ps, D]`` (one layer's pool slice, current token written);
    tables ``[B, max_pages]`` int32; pos ``[B]`` int32 (last valid cache
    index per row); hres ``[B, hidden]`` the residual stream entering the
    layer; wo ``[hidden, H*D]``; w_post/w_next ``[hidden]`` the attention
    junction's norm weight and the next layer's input norm (or the final
    norm); wg/wu ``[I, hidden]``; wd ``[hidden, I]``.

    Returns ``(y_next, h_next)``, both ``[B, hidden]`` in ``hres``'s dtype.
    A CPU tensor takes :func:`decode_layer_plain`; a CUDA tensor launches
    the kernel (bf16, contiguous, see :func:`unsupported_reason`) or
    raises. ``stamps``, an int64 CUDA tensor of 6, receives the device
    clock in ns at the kernel's start, after each of its phases but the
    last (:data:`PHASES`) and at its end, as block 0 sees them."""
    _check(q, k_layer, v_layer, tables, pos, hres, wo, w_post, wg, wu, wd,
           w_next)
    if q.device.type == "cpu":
        return decode_layer_plain(q, k_layer, v_layer, tables, pos, hres, wo,
                                  w_post, wg, wu, wd, w_next, eps_post,
                                  eps_next)
    if q.device.type != "cuda":
        raise ValueError(f"decode_layer: no kernel for device {q.device}")
    b, h, d = q.shape
    _, h_kv, ps, _ = k_layer.shape
    hd = hres.shape[1]
    i_size = wg.shape[0]
    ops = (q, k_layer, v_layer, tables, pos, hres, wo, w_post, wg, wu, wd,
           w_next)
    why = unsupported_reason(q.shape, k_layer.shape, tables.shape[1], hd,
                             i_size, q.dtype)
    if why is None and any(t.dtype != torch.bfloat16 for t in ops
                           if t.is_floating_point()):
        why = f"dtypes {sorted({str(t.dtype) for t in ops})} (takes bf16)"
    if why is not None:
        raise ValueError(f"decode_layer kernel does not take {why}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("decode_layer kernel takes contiguous tensors")
    _build.require_aligned("decode_layer", *ops)
    if block_i is None:
        block_i = _pick_block_i(i_size)
    block_i = int(block_i)
    if block_i <= 0 or block_i % 8 or i_size % block_i:
        raise ValueError(f"decode_layer: block_i {block_i} must be a "
                         f"multiple of 8 dividing {i_size}")
    if stamps is not None and (stamps.device != q.device or stamps.dtype !=
                               torch.int64 or stamps.shape != (6,)):
        raise ValueError("decode_layer: stamps must be an int64 [6] tensor "
                         "on q's device")
    y = torch.empty_like(hres)
    h_out = torch.empty_like(hres)
    n_scratch = _build.function("decode_layer", "ptt_decode_layer_scratch",
                                [ctypes.c_int] * 4)(b, h * d, hd, i_size)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=q.device)
    fn = _build.function("decode_layer", "ptt_decode_layer", _ARGS)
    err = fn(*(t.data_ptr() for t in ops), y.data_ptr(), h_out.data_ptr(),
             scratch.data_ptr(), b, h_kv, h // h_kv, d, ps, tables.shape[1],
             hd, i_size, block_i, float(eps_post), float(eps_next),
             None if stamps is None else stamps.data_ptr(),
             _build.stream_of(q))
    _build.check(err, "decode_layer")
    decode_layer.launches += 1
    return y, h_out


decode_layer.launches = 0

