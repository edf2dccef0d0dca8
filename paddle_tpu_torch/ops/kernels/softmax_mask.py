"""Masked row softmax of attention scores: the CUDA kernels (masked,
causal, backward), the plain versions and the autograd Functions.

Replaces ``paddle_tpu/ops/kernels/softmax_mask_pallas.py`` ``_fused_fwd``
(:67; kernel body ``_fwd_kernel`` :40), ``_fused_fwd_tri`` (:88;
``_fwd_tri_kernel`` :48) and ``_fused_bwd`` (:106; ``_bwd_kernel`` :59),
with the custom_vjps ``softmax_mask_fused`` (:133-169) and
``softmax_mask_tri`` (:172-191). Source:
``paddle_tpu_torch/csrc/softmax_mask.cu``.

For scores ``x [B, H, Sq, Sk]``::

    masked: y = softmax(x + mask)                      over the last axis
    causal: y = softmax(where(col <= q, x, -inf))      top-left triangle
    dx = (dy - sum(dy * y)) * y                        from the saved y

in f32, each output rounded once to ``x.dtype``. The causal triangle's
corner is the top left (``col <= q``, :52-54) also when ``Sq != Sk``; that
is not flash attention's bottom-right rule. A row masked wholly to -inf
gives NaN, as JAX's kernel does.

The mask's gradient is ``dx`` summed onto the mask's broadcast shape
(:151-166), so a trainable additive bias passed as the mask gets one. It
is plain tensor code after the kernel, as JAX sums it outside Pallas.

What bounds it on the H100: bytes. One block per row keeps the f32 row in
shared memory between the max, the sum and the output pass. The kernel
reads the mask through the strides of its broadcast view, 0 on every
broadcast axis, so the head axis is folded and never materialised, as
JAX's index map folds it (``i // heads``, :80). JAX sends a mask that is
not ``[B|1, 1, Sq|1, Sk|1]`` to its composite
(``paddle_tpu/incubate/operators.py:20-33``); this kernel takes every mask
that broadcasts to ``x``.

The card path takes bf16 or f32 scores ``[B, H, Sq, Sk]`` (a bf16 or f32
mask; another mask type is cast to f32 first) with ``Sk % 8 == 0``, and
raises otherwise; the plain versions take scores of any rank. A CPU
tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["softmax_mask", "softmax_mask_tri", "softmax_mask_bwd",
           "softmax_mask_plain", "softmax_mask_tri_plain",
           "softmax_mask_bwd_plain", "SoftmaxMaskFunction",
           "SoftmaxMaskTriFunction", "reduce_to_mask"]

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 3 \
    + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
#: shared memory a block may take (of 227 KB), less the static part
_SMEM = 227 * 1024 - 1024


def _check(x, what):
    if x.dim() < 2:
        raise ValueError(f"{what} takes scores [..., Sq, Sk], got "
                         f"{tuple(x.shape)}")
    if not x.is_floating_point():
        raise TypeError(f"{what} takes floating scores, got {x.dtype}")


def _check_mask(x, mask):
    try:
        fits = torch.broadcast_shapes(mask.shape, x.shape) == x.shape
    except RuntimeError:
        fits = False
    if not fits:
        raise ValueError(f"softmax_mask: mask {tuple(mask.shape)} does not "
                         f"broadcast to x {tuple(x.shape)}")
    if mask.device != x.device:
        raise ValueError("softmax_mask: operands on different devices")


def _tri_keep(sq, sk, device):
    return (torch.arange(sk, device=device)[None, :]
            <= torch.arange(sq, device=device)[:, None])


def softmax_mask_plain(x, mask):
    """``softmax(x + mask)`` in plain PyTorch, f32 inside
    (``reference_softmax_mask``, :194-205)."""
    _check(x, "softmax_mask")
    _check_mask(x, mask)
    return torch.softmax(x.float() + mask.float(), dim=-1).to(x.dtype)


def softmax_mask_tri_plain(x):
    """The causal softmax in plain PyTorch (the reference with
    ``mask=None``): ``-inf`` where ``col > q``."""
    _check(x, "softmax_mask_tri")
    keep = _tri_keep(x.shape[-2], x.shape[-1], x.device)
    xf = torch.where(keep, x.float(), float("-inf"))
    return torch.softmax(xf, dim=-1).to(x.dtype)


def softmax_mask_bwd_plain(y, dy):
    """``dx = (dy - sum(dy * y)) * y`` in plain PyTorch (``_bwd_kernel``)."""
    _check(y, "softmax_mask backward")
    yf, gf = y.float(), dy.float()
    return ((gf - (gf * yf).sum(-1, keepdim=True)) * yf).to(y.dtype)


def _kernel_checks(x, what, smem):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"{what} kernel takes scores [B, H, Sq, Sk], got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{what} kernel takes bf16 or f32, got {x.dtype}")
    sk = x.shape[-1]
    if sk % 8 or smem > _SMEM:
        raise ValueError(f"{what} kernel needs Sk % 8 == 0 and {smem} <= "
                         f"{_SMEM} bytes of shared memory, got Sk {sk}")
    if x.numel() // max(sk, 1) >= 2 ** 31:
        raise ValueError(f"{what}: {x.numel() // sk} rows past the kernel's "
                         f"grid")


def _forward(x, mask, what):
    _kernel_checks(x, what, 4 * x.shape[-1])
    x = x.contiguous()
    if mask is not None and mask.dtype not in _KERNEL_DTYPES:
        mask = mask.float()
    y = torch.empty_like(x)
    _build.require_aligned(what, x, y)
    _launch_fwd(x, mask, y, what, _build.stream_of(x))
    return y


def _launch_fwd(x, mask, y, what, stream):
    """The forward's C entry on operands the caller allocated: ``mask``
    (bf16 or f32, broadcasting to x) or None for the causal triangle."""
    b, h, sq, sk = x.shape
    strides = (0, 0, 0, 0)
    mask_f32 = 1
    if mask is not None:
        mask_f32 = int(mask.dtype == torch.float32)
        # the broadcast view's strides are 0 on every broadcast axis
        strides = mask.expand(b, h, sq, sk).stride()
    fn = _build.function("softmax_mask", "ptt_softmax_mask", _ARGS)
    err = fn(x.data_ptr(), None if mask is None else mask.data_ptr(),
             y.data_ptr(), b * h * sq, h, sq, sk, *strides,
             int(x.dtype == torch.float32), mask_f32, int(mask is None),
             stream)
    _build.check(err, what)


def softmax_mask(x, mask):
    """``softmax(x + mask)`` over the last axis of scores ``x``,
    ``mask`` any tensor that broadcasts to ``x``; in ``x.dtype``. A CPU
    tensor takes :func:`softmax_mask_plain`; a CUDA tensor launches the
    kernel or raises."""
    _check(x, "softmax_mask")
    _check_mask(x, mask)
    if x.device.type == "cpu":
        return softmax_mask_plain(x, mask)
    y = _forward(x, mask, "softmax_mask")
    softmax_mask.launches += 1
    return y


softmax_mask.launches = 0


def softmax_mask_tri(x):
    """The causal softmax of scores ``x`` (top-left triangle), as
    :func:`softmax_mask_tri_plain`; the same dispatch as
    :func:`softmax_mask`."""
    _check(x, "softmax_mask_tri")
    if x.device.type == "cpu":
        return softmax_mask_tri_plain(x)
    y = _forward(x, None, "softmax_mask_tri")
    softmax_mask_tri.launches += 1
    return y


softmax_mask_tri.launches = 0


def softmax_mask_bwd(y, dy):
    """``dx`` of either softmax from its saved output ``y`` and the
    cotangent ``dy`` (of y's shape and dtype), as
    :func:`softmax_mask_bwd_plain`; the same dispatch as
    :func:`softmax_mask`."""
    _check(y, "softmax_mask backward")
    if dy.shape != y.shape or dy.dtype != y.dtype or dy.device != y.device:
        raise ValueError(f"softmax_mask backward: dy {dy.dtype} "
                         f"{tuple(dy.shape)} must match y {y.dtype} "
                         f"{tuple(y.shape)}")
    if y.device.type == "cpu":
        return softmax_mask_bwd_plain(y, dy)
    _kernel_checks(y, "softmax_mask backward", 8 * y.shape[-1])
    y, dy = y.contiguous(), dy.contiguous()
    dx = torch.empty_like(y)
    _build.require_aligned("softmax_mask backward", y, dy, dx)
    _launch_bwd(y, dy, dx, _build.stream_of(y))
    softmax_mask_bwd.launches += 1
    return dx


softmax_mask_bwd.launches = 0


def _launch_bwd(y, dy, dx, stream):
    """The backward's C entry on operands the caller allocated."""
    fn = _build.function("softmax_mask", "ptt_softmax_mask_bwd", _BWD_ARGS)
    err = fn(y.data_ptr(), dy.data_ptr(), dx.data_ptr(),
             y.numel() // y.shape[-1], y.shape[-1],
             int(y.dtype == torch.float32), stream)
    _build.check(err, "softmax_mask backward")


def reduce_to_mask(dx, mask_shape, mask_dtype):
    """``dx`` summed onto the mask's broadcast shape, as JAX's ``_vjp_bwd``
    (:151-166) sums it: the leading axes the mask lacks first, then each
    axis where the mask has 1, then one cast to the mask's dtype."""
    dm = dx
    extra = dm.dim() - len(mask_shape)
    if extra:
        dm = dm.sum(dim=tuple(range(extra)))
    axes = tuple(i for i, (want, have) in enumerate(zip(mask_shape, dm.shape))
                 if want == 1 and have != 1)
    if axes:
        dm = dm.sum(dim=axes, keepdim=True)
    return dm.to(mask_dtype)


class SoftmaxMaskFunction(torch.autograd.Function):
    """``softmax(x + mask)`` with the backward kernel (``softmax_mask_fused``,
    :133-169). ``apply(x, mask, plain)``; it saves ``y``. The mask's
    gradient, when it needs one, is ``dx`` reduced onto its shape."""

    @staticmethod
    def forward(ctx, x, mask, plain):
        y = (softmax_mask_plain if plain else softmax_mask)(x, mask)
        ctx.save_for_backward(y)
        ctx.mask_meta = (tuple(mask.shape), mask.dtype)
        ctx.plain = plain
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        bwd = softmax_mask_bwd_plain if ctx.plain else softmax_mask_bwd
        dx = bwd(y, dy.contiguous())
        dm = reduce_to_mask(dx, *ctx.mask_meta) \
            if ctx.needs_input_grad[1] else None
        return (dx if ctx.needs_input_grad[0] else None), dm, None


class SoftmaxMaskTriFunction(torch.autograd.Function):
    """The causal softmax with the backward kernel (``softmax_mask_tri``,
    :172-191). ``apply(x, plain)``; it saves ``y``."""

    @staticmethod
    def forward(ctx, x, plain):
        y = (softmax_mask_tri_plain if plain else softmax_mask_tri)(x)
        ctx.save_for_backward(y)
        ctx.plain = plain
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        bwd = softmax_mask_bwd_plain if ctx.plain else softmax_mask_bwd
        return bwd(y, dy.contiguous()), None


# -- declared launches for the kernel analyzer -------------------------------

def pad_mask(batch, seq, seed):
    """An additive ``[batch, 1, seq, seq]`` bf16 padding mask on the CPU: 0
    before each sequence's length, -1e4 from it on, the lengths drawn from
    ``seed`` in [seq / 2, seq]."""
    gen = torch.Generator().manual_seed(seed)
    lengths = torch.randint(seq // 2, seq + 1, (batch,), generator=gen)
    past = torch.arange(seq)[None, :] >= lengths[:, None]
    mask = torch.where(past, -1e4, 0.0).to(torch.bfloat16)
    return mask[:, None, None, :].expand(batch, 1, seq, seq).contiguous()


def _threads(sk):
    return max(32, min(1024, -(-(sk // 8) // 32) * 32))


def _ex(label, b, h, sq, sk, kind, dtype=torch.bfloat16):
    """A block a row of scores (``kind``: "mask" with a [B, 1, Sq, Sk]
    padding mask, "tri" the causal triangle, or "bwd"); the row in shared
    memory as f32 (two rows for the backward)."""
    from ._examples import CTYPE, fixed, model, normal
    m = model()
    shape = (b, h, sq, sk)
    rows = b * h * sq
    n = rows * sk
    ct = CTYPE[dtype]
    if kind == "bwd":
        ops = [m.Operand("y", shape, dtype), m.Operand("dy", shape, dtype),
               m.Operand("dx", shape, dtype, "out")]

        def prepare(t):
            t["y"] = torch.softmax(t["y"].float() * 3.0, -1).to(dtype)

        def plain(t):
            return {"dx": softmax_mask_bwd_plain(t["y"], t["dy"])}

        def launch(t, stream):
            _launch_bwd(t["y"], t["dy"], t["dx"], stream)

        kern = m.KernelLaunch(f"softmax_mask_bwd_kernel<{ct}>", rows,
                              _threads(sk), smem=8 * sk,
                              writes=[m.rows_map("dx", rows, sk)])
        return m.Example(label, "softmax_mask", ops, [kern], launch, plain,
                         flops=4 * n, nbytes=3 * n * dtype.itemsize,
                         prepare=prepare)
    ops = [m.Operand("x", shape, dtype, data=normal(shape, dtype, 3.0)),
           m.Operand("y", shape, dtype, "out")]
    mask_bytes = 0
    if kind == "mask":
        mk = pad_mask(b, sk, seed=91)[:, :, :sq]
        ops.append(m.Operand("mask", tuple(mk.shape), torch.bfloat16,
                             data=fixed(mk)))
        mask_bytes = mk.numel() * 2

    def plain(t):
        if kind == "mask":
            return {"y": softmax_mask_plain(t["x"], t["mask"])}
        return {"y": softmax_mask_tri_plain(t["x"])}

    def launch(t, stream):
        _launch_fwd(t["x"], t.get("mask"), t["y"], label, stream)

    mt = "__nv_bfloat16" if kind == "mask" else "float"
    kern = m.KernelLaunch(
        f"softmax_mask_kernel<{ct},{mt},{str(kind == 'tri').lower()}>", rows,
        _threads(sk), smem=4 * sk, writes=[m.rows_map("y", rows, sk)],
        reads=[m.rows_map("x", rows, sk)])
    return m.Example(label, "softmax_mask", ops, [kern], launch, plain,
                     flops=6 * n, nbytes=2 * n * dtype.itemsize + mask_bytes)


def ck_examples():
    """At ``softmax_mask_pallas.pk_examples``' shapes (16 heads of [512,
    512] scores as [2, 8, 512, 512], a [2, 1, 512, 512] mask) and phase 3's
    (GPT-2 small's [8, 12, 1024, 1024] with a padding mask, causal, and the
    backward; causal [2, 32, 2048, 2048]); tails with a key length that
    leaves threads of the last warp idle and an odd row count."""
    from ._examples import with_tail
    out = []
    for label, b, h, s, kind in (
            ("softmax_mask_fwd", 2, 8, 512, "mask"),
            ("softmax_tri_fwd", 2, 8, 512, "tri"),
            ("softmax_bwd", 2, 8, 512, "bwd"),
            ("phase3 [8, 12, 1024, 1024] mask", 8, 12, 1024, "mask"),
            ("phase3 [8, 12, 1024, 1024] causal", 8, 12, 1024, "tri"),
            ("phase3 [2, 32, 2048, 2048] causal", 2, 32, 2048, "tri"),
            ("phase3 bwd [8, 12, 1024, 1024]", 8, 12, 1024, "bwd")):
        out.append(with_tail(_ex, label, dict(b=b, h=h, sq=s, sk=s,
                                              kind=kind),
                             dict(b=1, h=3, sq=1000, sk=1000, kind=kind)))
    return out
