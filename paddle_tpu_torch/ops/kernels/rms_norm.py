"""RMSNorm with an optional residual add, forward and backward: CUDA
kernels, plain versions and the autograd Function.

Replaces ``paddle_tpu/ops/kernels/rms_norm_pallas.py`` ``_fused_fwd``
(:82; kernel bodies :31-44) and ``_fused_bwd`` (:114; kernel body
:46-66), reached through the custom_vjp ``rms_norm_fused`` (:154-176).
Source: ``paddle_tpu_torch/csrc/rms_norm.cu``.

What bounds it on the H100: bytes — one read of ``x`` (and ``res``) and
one write of ``y`` (and ``h``) per row, a few operations per element. The
kernel gives each row one block that moves 16-byte vectors and keeps the
f32 row in shared memory between the statistics pass and the scaling
pass, so nothing is read twice from device memory.

Numerics follow the TPU kernel, not the JAX composite: ``h`` stays in f32,
``y = h * rstd * w`` is computed in f32 and cast once. The composite
(``paddle_tpu/nn/functional/__init__.py:104-110``) casts ``h * rstd`` to
the input dtype before multiplying by ``w``; in bf16 that rounds twice
and can differ from this version by one bf16 ulp.

Backward (:class:`RMSNormFunction`): the forward saves ``h`` (the pre-norm
sum, or ``x`` without a residual) in the input dtype and the backward
recomputes rstd from it. The cotangent of the returned sum joins ``dx``
and ``d(residual) = dx`` (:162-173). One difference from the JAX
backward: that cotangent is added to ``dx`` in f32 inside the kernel, before
``dx`` is rounded, where the JAX package adds it after the rounding; in
f32 the two agree. What bounds the backward: bytes — ``h`` and ``g`` (and
the sum's cotangent) read once and ``dx`` written once; ``dw`` comes as one
f32 partial row per group of rows, summed by the wrapper.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["rms_norm", "rms_norm_plain", "rms_norm_bwd", "rms_norm_bwd_plain",
           "RMSNormFunction"]

_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                 ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float,
                                                          ctypes.c_void_p]
_MAX_HIDDEN = 8192       # the backward kernel: 4 vectors a thread, 256 threads
_ROW_GROUPS = 264        # backward: aim at two blocks for each of 132 SMs


def _check(x, weight, residual):
    if not (x.is_floating_point() and weight.is_floating_point()):
        raise TypeError(f"rms_norm takes floating tensors, got {x.dtype} "
                        f"and {weight.dtype}")
    if x.dim() < 1 or weight.shape != x.shape[-1:]:
        raise ValueError(f"rms_norm: weight {tuple(weight.shape)} does not "
                         f"match the last dim of x {tuple(x.shape)}")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype):
        raise ValueError(f"rms_norm: residual {tuple(residual.shape)} "
                         f"{residual.dtype} must match x {tuple(x.shape)} "
                         f"{x.dtype}")
    for t in (weight, residual):
        if t is not None and t.device != x.device:
            raise ValueError("rms_norm: operands on different devices")


def rms_norm_plain(x, weight, residual=None, eps=1e-6):
    """The same function in plain PyTorch. Returns ``y``, or ``(y, h)``
    with ``h = x + residual`` when a residual is given."""
    _check(x, weight, residual)
    h = x.float() if residual is None else x.float() + residual.float()
    rstd = torch.rsqrt(h.square().mean(-1, keepdim=True) + eps)
    y = (h * rstd * weight.float()).to(x.dtype)
    return y if residual is None else (y, h.to(x.dtype))


def rms_norm(x, weight, residual=None, eps=1e-6):
    """RMSNorm over the last dim. A CPU tensor takes :func:`rms_norm_plain`;
    a CUDA tensor launches the kernel (bf16, contiguous, last dim a
    multiple of 8) or raises."""
    _check(x, weight, residual)
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, residual, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm: no kernel for device {x.device}")
    hidden = x.shape[-1]
    if x.dtype != torch.bfloat16 or weight.dtype != torch.bfloat16:
        raise TypeError(f"rms_norm kernel takes bf16, got {x.dtype} / "
                        f"{weight.dtype}")
    if hidden % 8:
        raise ValueError(f"rms_norm kernel needs hidden % 8 == 0, got {hidden}")
    if not all(t.is_contiguous() for t in (x, weight, residual)
               if t is not None):
        raise ValueError("rms_norm kernel takes contiguous tensors")
    _build.require_aligned("rms_norm", x, weight, residual)
    y = torch.empty_like(x)
    h = None if residual is None else torch.empty_like(x)
    _launch_fwd(x, weight, residual, y, h, eps, _build.stream_of(x))
    rms_norm.launches += 1
    return y if residual is None else (y, h)


rms_norm.launches = 0


def _launch_fwd(x, weight, residual, y, h, eps, stream):
    """The forward's C entry on operands the caller allocated."""
    hidden = x.shape[-1]
    fn = _build.function("rms_norm", "ptt_rms_norm", _ARGS)
    err = fn(x.data_ptr(), None if residual is None else residual.data_ptr(),
             weight.data_ptr(), y.data_ptr(), None if h is None else h.data_ptr(),
             x.numel() // hidden, hidden, float(eps), stream)
    _build.check(err, "rms_norm")


def _bwd_rows_per_block(rows: int) -> int:
    return max(1, min(32, -(-rows // _ROW_GROUPS)))


def _launch_bwd(h, weight, g, g_h, dx, part, eps, stream):
    """The backward's C entry on operands the caller allocated."""
    hidden = h.shape[-1]
    rows = h.numel() // hidden
    fn = _build.function("rms_norm", "ptt_rms_norm_bwd", _BWD_ARGS)
    err = fn(h.data_ptr(), weight.data_ptr(), g.data_ptr(),
             None if g_h is None else g_h.data_ptr(), dx.data_ptr(),
             part.data_ptr(), rows, _bwd_rows_per_block(rows), hidden,
             float(eps), stream)
    _build.check(err, "rms_norm backward")


def _check_bwd(h, weight, g, g_h):
    if not (h.is_floating_point() and weight.is_floating_point()):
        raise TypeError(f"rms_norm backward takes floating tensors, got "
                        f"{h.dtype} and {weight.dtype}")
    if h.dim() < 1 or weight.shape != h.shape[-1:]:
        raise ValueError(f"rms_norm backward: weight {tuple(weight.shape)} "
                         f"does not match the last dim of h {tuple(h.shape)}")
    for t in (g, g_h):
        if t is not None and (t.shape != h.shape or t.dtype != h.dtype
                              or t.device != h.device):
            raise ValueError(f"rms_norm backward: cotangent {t.dtype} "
                             f"{tuple(t.shape)} must match h {h.dtype} "
                             f"{tuple(h.shape)} on {h.device}")
    if weight.device != h.device:
        raise ValueError("rms_norm backward: operands on different devices")


def rms_norm_bwd_plain(h, weight, g, g_h=None, eps=1e-6):
    """The backward in plain PyTorch: ``(dx, dw)`` of ``y = rmsnorm(h) * w``
    for the cotangent ``g`` of ``y`` (and ``g_h`` of the returned sum,
    added to ``dx`` before its one rounding); ``dw`` in the weight's
    dtype."""
    _check_bwd(h, weight, g, g_h)
    hidden = h.shape[-1]
    hf, gf = h.float(), g.float()
    rstd = torch.rsqrt(hf.square().mean(-1, keepdim=True) + eps)
    u = gf * weight.float()
    dot = (hf * u).sum(-1, keepdim=True)
    dx = rstd * u - hf * (rstd * rstd * rstd) * (dot * (1.0 / hidden))
    if g_h is not None:
        dx = dx + g_h.float()
    dw = (gf * hf * rstd).reshape(-1, hidden).sum(0)
    return dx.to(h.dtype), dw.to(weight.dtype)


def rms_norm_bwd(h, weight, g, g_h=None, eps=1e-6):
    """``(dx, dw)``, as :func:`rms_norm_bwd_plain`. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel (bf16, contiguous,
    last dim a multiple of 8 and at most 8192) or raises."""
    _check_bwd(h, weight, g, g_h)
    if h.device.type == "cpu":
        return rms_norm_bwd_plain(h, weight, g, g_h, eps)
    if h.device.type != "cuda":
        raise ValueError(f"rms_norm backward: no kernel for device {h.device}")
    hidden = h.shape[-1]
    if h.dtype != torch.bfloat16 or weight.dtype != torch.bfloat16:
        raise TypeError(f"rms_norm backward kernel takes bf16, got {h.dtype} "
                        f"/ {weight.dtype}")
    if hidden % 8 or hidden > _MAX_HIDDEN:
        raise ValueError(f"rms_norm backward kernel needs hidden % 8 == 0 and "
                         f"hidden <= {_MAX_HIDDEN}, got {hidden}")
    if not all(t.is_contiguous() for t in (h, weight, g, g_h)
               if t is not None):
        raise ValueError("rms_norm backward kernel takes contiguous tensors")
    _build.require_aligned("rms_norm backward", h, weight, g, g_h)
    rows = h.numel() // hidden
    per_block = _bwd_rows_per_block(rows)
    dx = torch.empty_like(h)
    part = torch.empty(max(1, -(-rows // per_block)), hidden,
                       dtype=torch.float32, device=h.device)
    if rows == 0:
        part.zero_()
    _launch_bwd(h, weight, g, g_h, dx, part, eps, _build.stream_of(h))
    rms_norm_bwd.launches += 1
    return dx, part.sum(0).to(weight.dtype)


rms_norm_bwd.launches = 0


class RMSNormFunction(torch.autograd.Function):
    """``rms_norm`` with its backward kernel (the custom_vjp of
    ``rms_norm_fused``). ``apply(x, weight, residual, eps, plain)`` returns
    ``y``, or ``(y, h)`` with a residual; ``plain`` runs the plain forward
    and the plain backward."""

    @staticmethod
    def forward(ctx, x, weight, residual, eps, plain):
        fwd = rms_norm_plain if plain else rms_norm
        out = fwd(x, weight, residual, eps)
        h = x if residual is None else out[1]
        ctx.save_for_backward(h, weight)
        ctx.eps, ctx.plain, ctx.has_res = eps, plain, residual is not None
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, g_y, g_h=None):
        h, weight = ctx.saved_tensors
        if g_y is None:
            return g_h, None, g_h, None, None
        bwd = rms_norm_bwd_plain if ctx.plain else rms_norm_bwd
        dx, dw = bwd(h, weight, g_y.contiguous(),
                     None if g_h is None else g_h.contiguous(), ctx.eps)
        return dx, dw, (dx if ctx.has_res else None), None, None


# -- declared launches for the kernel analyzer -------------------------------

def _ex_fwd(label, rows, hidden, residual):
    from ._examples import model, normal, row_threads
    m = model()
    bf = torch.bfloat16
    ops = [m.Operand("x", (rows, hidden), bf),
           m.Operand("w", (hidden,), bf, data=normal((hidden,), bf, 0.1, 1.0)),
           m.Operand("y", (rows, hidden), bf, "out")]
    writes = [m.rows_map("y", rows, hidden)]
    reads = [m.rows_map("x", rows, hidden), m.whole_map("w", (hidden,))]
    if residual:
        ops += [m.Operand("res", (rows, hidden), bf),
                m.Operand("h", (rows, hidden), bf, "out")]
        writes.append(m.rows_map("h", rows, hidden))
        reads.append(m.rows_map("res", rows, hidden))

    def plain(t):
        out = rms_norm_plain(t["x"], t["w"], t.get("res"), 1e-5)
        return {"y": out[0], "h": out[1]} if residual else {"y": out}

    def launch(t, stream):
        _launch_fwd(t["x"], t["w"], t.get("res"), t["y"], t.get("h"), 1e-5,
                    stream)

    kern = m.KernelLaunch(
        f"rms_norm_kernel<{'true' if residual else 'false'}>", rows,
        row_threads(hidden // 8), smem=4 * hidden, writes=writes, reads=reads)
    return m.Example(label, "rms_norm", ops, [kern], launch, plain,
                     flops=5 * rows * hidden,
                     nbytes=2 * rows * hidden * (2 if residual else 1) * 2
                     + 2 * hidden)


def _ex_bwd(label, rows, hidden, with_gh):
    from ._examples import model, normal
    m = model()
    bf = torch.bfloat16
    per = _bwd_rows_per_block(rows)
    blocks = -(-rows // per)
    vecs = hidden // 8
    threads = min(256, -(-vecs // 32) * 32)
    v = -(-vecs // threads)
    ops = [m.Operand("h", (rows, hidden), bf),
           m.Operand("w", (hidden,), bf, data=normal((hidden,), bf, 0.1, 1.0)),
           m.Operand("g", (rows, hidden), bf),
           m.Operand("dx", (rows, hidden), bf, "out"),
           m.Operand("part", (blocks, hidden), torch.float32, "out")]
    reads = [m.rows_map("h", rows, hidden, per), m.rows_map("g", rows, hidden,
                                                            per),
             m.whole_map("w", (hidden,))]
    if with_gh:
        ops.append(m.Operand("gh", (rows, hidden), bf))
        reads.append(m.rows_map("gh", rows, hidden, per))

    def plain(t):
        hf, gf = t["h"].float(), t["g"].float()
        rstd = torch.rsqrt(hf.square().mean(-1, keepdim=True) + 1e-5)
        dx = rms_norm_bwd_plain(t["h"], t["w"], t["g"], t.get("gh"), 1e-5)[0]
        contrib = torch.zeros(blocks * per, hidden, device=hf.device)
        contrib[:rows] = gf * hf * rstd
        return {"dx": dx, "part": contrib.view(blocks, per, hidden).sum(1)}

    def launch(t, stream):
        _launch_bwd(t["h"], t["w"], t["g"], t.get("gh"), t["dx"], t["part"],
                    1e-5, stream)

    kern = m.KernelLaunch(
        f"rms_norm_bwd_kernel<{v}>", blocks, threads,
        writes=[m.rows_map("dx", rows, hidden, per),
                m.rows_map("part", blocks, hidden)], reads=reads)
    return m.Example(label, "rms_norm", ops, [kern], launch, plain,
                     flops=10 * rows * hidden,
                     nbytes=2 * rows * hidden * (3 + with_gh) + 2 * hidden * 2,
                     tol=2.0 ** -6)


def ck_examples():
    """The forward at ``rms_norm_pallas.pk_examples``' shapes ([512, 1024])
    and phase 3's ([8, 4096], [512, 4096], with and without the residual),
    the backward at [512, 1024] and phase 3's [4096, 4096] (with and
    without the sum's cotangent); each with a tail of an odd row count and
    a hidden width that leaves threads of the last warp idle."""
    from ._examples import with_tail
    out = []
    for label, rows, hidden, res in (
            ("rms_fwd_plain", 512, 1024, False),
            ("rms_fwd_res", 512, 1024, True),
            ("phase3 [8, 4096]", 8, 4096, False),
            ("phase3 [8, 4096] residual", 8, 4096, True),
            ("phase3 [512, 4096]", 512, 4096, False),
            ("phase3 [512, 4096] residual", 512, 4096, True)):
        out.append(with_tail(_ex_fwd, label,
                             dict(rows=rows, hidden=hidden, residual=res),
                             dict(rows=rows + 3, hidden=hidden + 8,
                                  residual=res)))
    for label, rows, hidden, gh in (
            ("rms_bwd", 512, 1024, False),
            ("phase3 [4096, 4096]", 4096, 4096, False),
            ("phase3 [4096, 4096] residual cotangent", 4096, 4096, True)):
        out.append(with_tail(_ex_bwd, label,
                             dict(rows=rows, hidden=hidden, with_gh=gh),
                             dict(rows=rows + 5, hidden=hidden + 8,
                                  with_gh=gh)))
    return out
