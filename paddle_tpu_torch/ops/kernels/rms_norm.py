"""RMSNorm with an optional residual add, forward and backward: CUDA
kernels, plain versions and the autograd Function.

Replaces ``paddle_tpu/ops/kernels/rms_norm_pallas.py`` ``_fused_fwd``
(:82; kernel bodies :31-44) and ``_fused_bwd`` (:114; kernel body
:46-66), reached through the custom_vjp ``rms_norm_fused`` (:154-176).
Source: ``paddle_tpu_torch/csrc/rms_norm.cu``.

What bounds it on the H100: bytes — one read of ``x`` (and ``res``) and
one write of ``y`` (and ``h``) per row, a few operations per element. The
kernel holds a row in the registers of its block, a vector of 8 a thread,
and requests ``w``, ``x`` and ``res`` before its one reduction, so a row
costs one memory round trip; :func:`plan` (``_norm_rows.plan``, shared
with the block epilogue's forward) keeps rows past 8192 in shared memory
instead.

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
the sum's cotangent) read once and ``dx`` written once. A group of warps
owns a row and walks a strip of rows with its next rows landing in a
bulk-copy ring (:func:`bwd_plan`); each block writes one f32 partial row
of ``dw``, which a second kernel of the same C entry adds in a fixed
order into ``dw`` in the weight's dtype.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from ._norm_rows import WIDE_HIDDEN, plan

__all__ = ["rms_norm", "rms_norm_plain", "rms_norm_bwd", "rms_norm_bwd_plain",
           "RMSNormFunction", "plan", "bwd_plan", "make_bwd", "BwdPlan"]

# rows, hidden, eps, the plan's launch word, the stream
_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                 ctypes.c_longlong, ctypes.c_void_p]
# h, w, g, gh, dx, part, dw; rows, hidden, eps, the plan's launch word, the
# stream
_BWD_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_longlong,
                                     ctypes.c_void_p]
#: phase 3's forward rows (rows, hidden, residual): the decode rows, the
#: prefill chunk's, the Qwen2-MoE forward's, the unfused Llama train step's
FWD_SHAPES = ((8, 4096, False), (8, 4096, True), (512, 4096, False),
              (512, 4096, True), (2048, 2048, True), (4096, 4096, False),
              (4096, 4096, True))
#: phase 3's backward rows (rows, hidden): the Llama train step's and the
#: Qwen2-MoE train step's, each with and without the sum's cotangent
BWD_SHAPES = ((4096, 4096), (4096, 2048))

# The backward's launch constants, as in csrc/rms_norm.cu: 16-byte vectors
# a lane, warps of a group at most, warps of a block of several groups,
# threads of a block at most (128 registers a thread), ring stages, the
# dynamic shared memory a block may take, rows a sum block splits; and the
# card's SMs
_BWD_VECS, _BWD_MAX_GROUP_WARPS, _BWD_BLOCK_WARPS = 2, 16, 8
_BWD_MAX_THREADS, _BWD_STAGES, _BWD_SMEM_MAX, _SUM_ROWS = 512, 3, 226 * 1024, 8
_MAX_HIDDEN = 8 * _BWD_VECS * 32 * _BWD_MAX_GROUP_WARPS    # 8192
_SMS = 132


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
    multiple of 8 and at most ``_norm_rows.WIDE_HIDDEN``) or raises."""
    _check(x, weight, residual)
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, residual, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm: no kernel for device {x.device}")
    hidden = x.shape[-1]
    if x.dtype != torch.bfloat16 or weight.dtype != torch.bfloat16:
        raise TypeError(f"rms_norm kernel takes bf16, got {x.dtype} / "
                        f"{weight.dtype}")
    if hidden % 8 or hidden > WIDE_HIDDEN:
        raise ValueError(f"rms_norm kernel needs hidden % 8 == 0 and hidden "
                         f"<= {WIDE_HIDDEN}, got {hidden}")
    if not (x.is_contiguous() and weight.is_contiguous()
            and (residual is None or residual.is_contiguous())):
        raise ValueError("rms_norm kernel takes contiguous tensors")
    _build.require_aligned("rms_norm", x, weight, residual)
    y = torch.empty_like(x)
    h = None if residual is None else torch.empty_like(x)
    _launch_fwd(x, weight, residual, y, h, eps, _build.stream_of(x))
    rms_norm.launches += 1
    return y if residual is None else (y, h)


rms_norm.launches = 0


def _launch_fwd(x, weight, residual, y, h, eps, stream):
    """The forward's C entry on operands the caller allocated, launched as
    :func:`plan` says."""
    hidden = x.shape[-1]
    rows = x.numel() // hidden
    fn = _build.function("rms_norm", "ptt_rms_norm", _ARGS)
    err = fn(x.data_ptr(), None if residual is None else residual.data_ptr(),
             weight.data_ptr(), y.data_ptr(), None if h is None else h.data_ptr(),
             rows, hidden, float(eps), plan(rows, hidden).word, stream)
    _build.check(err, "rms_norm")


class BwdPlan(NamedTuple):
    """The backward's launch: ``blocks`` blocks of ``groups`` groups of
    ``group_warps`` warps, each group a strip of ``strip`` consecutive
    rows, ``smem`` bytes of dynamic shared memory (each group's ring), and
    ``word``, all of it as ``ptt_rms_norm_bwd`` takes it."""
    group_warps: int
    groups: int
    strip: int
    blocks: int
    threads: int
    smem: int
    word: int


def make_bwd(rows: int, hidden: int, has_gh: bool,
             blocks_sm: int = 1) -> BwdPlan:
    """The backward's launch at ``[rows, hidden]``: a group of
    ceil(hidden / 512) warps a row (two vectors of 8 a lane), 8 / group
    warps groups a block (or one); the strips sized so that ``blocks_sm``
    blocks an SM fill the card once."""
    vecs = hidden // 8
    gw = max(1, -(-vecs // (32 * _BWD_VECS)))
    ng = max(1, _BWD_BLOCK_WARPS // gw)
    smem = ng * _BWD_STAGES * ((2 + bool(has_gh)) * hidden * 2 + 8)
    per = ng * max(1, -(-rows // (_SMS * blocks_sm * ng)))
    strip = per // ng
    blocks = -(-rows // per)
    word = gw | ng << 8 | strip << 12 | blocks << 32
    return BwdPlan(gw, ng, strip, blocks, 32 * gw * ng, smem, word)


@functools.lru_cache(maxsize=None)
def bwd_plan(rows: int, hidden: int, has_gh: bool) -> BwdPlan:
    """The backward's launch at ``[rows, hidden]`` (with the sum's
    cotangent or without), decided from the shapes alone: one block an SM,
    which the probes found fastest (``PERF.md`` §6)."""
    return make_bwd(rows, hidden, has_gh)


def _launch_bwd(h, weight, g, g_h, dx, part, dw, eps, p, stream):
    """The backward's C entry (the rows kernel, then the sum kernel) on
    operands the caller allocated, launched as plan ``p`` says: ``part
    [p.blocks, hidden]`` f32 scratch, ``dw [hidden]`` bf16."""
    hidden = h.shape[-1]
    rows = h.numel() // hidden
    fn = _build.function("rms_norm", "ptt_rms_norm_bwd", _BWD_ARGS)
    err = fn(h.data_ptr(), weight.data_ptr(), g.data_ptr(),
             None if g_h is None else g_h.data_ptr(), dx.data_ptr(),
             part.data_ptr(), dw.data_ptr(), rows, hidden, float(eps),
             p.word, stream)
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
    p = bwd_plan(rows, hidden, g_h is not None)
    dx = torch.empty_like(h)
    part = torch.empty(p.blocks, hidden, dtype=torch.float32,
                       device=h.device)
    dw = torch.empty(hidden, dtype=weight.dtype, device=h.device)
    _launch_bwd(h, weight, g, g_h, dx, part, dw, eps, p, _build.stream_of(h))
    rms_norm_bwd.launches += 1
    return dx, dw


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
    """The launch :func:`plan` gives: y (and h) rows written, x (and res)
    rows read by the blocks that take them, w read whole."""
    from ._examples import model, normal
    from ._norm_rows import declare
    m = model()
    bf = torch.bfloat16
    ops = [m.Operand("x", (rows, hidden), bf),
           m.Operand("w", (hidden,), bf, data=normal((hidden,), bf, 0.1, 1.0)),
           m.Operand("y", (rows, hidden), bf, "out")]
    writes, reads = [("y", hidden)], [("x", hidden)]
    if residual:
        ops += [m.Operand("res", (rows, hidden), bf),
                m.Operand("h", (rows, hidden), bf, "out")]
        writes.append(("h", hidden))
        reads.append(("res", hidden))

    def plain(t):
        out = rms_norm_plain(t["x"], t["w"], t.get("res"), 1e-5)
        return {"y": out[0], "h": out[1]} if residual else {"y": out}

    def launch(t, stream):
        _launch_fwd(t["x"], t["w"], t.get("res"), t["y"], t.get("h"), 1e-5,
                    stream)

    kern = declare(m, f"rms_norm_kernel<{'true' if residual else 'false'}>",
                   plan(rows, hidden), rows, hidden, writes, reads, ("w",))
    return m.Example(label, "rms_norm", ops, [kern], launch, plain,
                     flops=5 * rows * hidden,
                     nbytes=declared_bytes(rows, hidden, residual))


def declared_bytes(rows, hidden, residual):
    """The bytes a forward call must move: x (and res) read and y (and h)
    written once, bf16, and w read once."""
    return 2 * rows * hidden * (2 if residual else 1) * 2 + 2 * hidden


def _ex_bwd(label, rows, hidden, with_gh):
    """The rows kernel as :func:`bwd_plan` launches it (a block takes
    ``groups`` strips of consecutive rows: dx rows written, one f32 partial
    row of dw), then the sum kernel (32 columns of dw a block)."""
    from ._examples import model, normal
    m = model()
    bf = torch.bfloat16
    p = bwd_plan(rows, hidden, with_gh)
    per = p.groups * p.strip
    ops = [m.Operand("h", (rows, hidden), bf),
           m.Operand("w", (hidden,), bf, data=normal((hidden,), bf, 0.1, 1.0)),
           m.Operand("g", (rows, hidden), bf),
           m.Operand("dx", (rows, hidden), bf, "out"),
           m.Operand("part", (p.blocks, hidden), torch.float32, "out"),
           m.Operand("dw", (hidden,), bf, "out")]
    reads = [m.rows_map("h", rows, hidden, per),
             m.rows_map("g", rows, hidden, per), m.whole_map("w", (hidden,))]
    if with_gh:
        ops.append(m.Operand("gh", (rows, hidden), bf))
        reads.append(m.rows_map("gh", rows, hidden, per))

    def plain(t):
        dx, dw = rms_norm_bwd_plain(t["h"], t["w"], t["g"], t.get("gh"),
                                    1e-5)
        hf, gf = t["h"].float(), t["g"].float()
        rstd = torch.rsqrt(hf.square().mean(-1, keepdim=True) + 1e-5)
        return {"dx": dx, "part": (gf * hf * rstd).sum(0), "dw": dw}

    def launch(t, stream):
        _launch_bwd(t["h"], t["w"], t["g"], t.get("gh"), t["dx"], t["part"],
                    t["dw"], 1e-5, p, stream)

    kernels = [
        m.KernelLaunch(
            f"rms_norm_bwd_kernel<{'true' if with_gh else 'false'}>",
            p.blocks, p.threads, smem=p.smem,
            writes=[m.rows_map("dx", rows, hidden, per),
                    m.rows_map("part", p.blocks, hidden)], reads=reads),
        m.KernelLaunch("rms_norm_bwd_sum_kernel", -(-hidden // 32),
                       32 * _SUM_ROWS,
                       writes=[m.TileMap("dw", (32,), lambda x, y, z: (x,))])]
    return m.Example(label, "rms_norm", ops, kernels, launch, plain,
                     flops=10 * rows * hidden,
                     nbytes=bwd_declared_bytes(rows, hidden, with_gh),
                     tol={"part": 1e-3, "dw": 1e-3 + 2.0 ** -7,
                          "*": 2.0 ** -6},
                     reduce={"part": lambda v: v.sum(0)})


def bwd_declared_bytes(rows, hidden, with_gh):
    """The bytes a backward call must move, bf16: h, g (and the sum's
    cotangent) read and dx written once, w read and dw written once."""
    return 2 * rows * hidden * (3 + bool(with_gh)) + 2 * hidden * 2


def bwd_label(rows, hidden, with_gh):
    """The label of phase 3's backward row (its ``ck_examples`` entry)."""
    return f"phase3 [{rows}, {hidden}]" + (" residual cotangent" if with_gh
                                           else "")


def fwd_label(rows, hidden, residual):
    """The label of phase 3's forward row (its ``ck_examples`` entry)."""
    return f"phase3 forward [{rows}, {hidden}]" + (" residual" if residual
                                                    else "")


def ck_examples():
    """The forward at ``rms_norm_pallas.pk_examples``' shapes ([512, 1024]),
    past 8192 (the wide arm) and at phase 3's (:data:`FWD_SHAPES`), the
    backward at [512, 1024] and phase 3's (:data:`BWD_SHAPES`, with and
    without the sum's cotangent); each with a tail of an odd row count and
    a hidden width that leaves threads of the last warp idle."""
    from ._examples import with_tail
    out = []
    fwd = [("rms_fwd_plain", 512, 1024, False), ("rms_fwd_res", 512, 1024, True),
           ("wide [37, 12288] residual", 37, 12288, True)]
    fwd += [(fwd_label(rows, hidden, res), rows, hidden, res)
            for rows, hidden, res in FWD_SHAPES]
    for label, rows, hidden, res in fwd:
        out.append(with_tail(_ex_fwd, label,
                             dict(rows=rows, hidden=hidden, residual=res),
                             dict(rows=rows + 3, hidden=hidden + 8,
                                  residual=res)))
    bwd = [("rms_bwd", 512, 1024, False)]
    bwd += [(bwd_label(rows, hidden, gh), rows, hidden, gh)
            for rows, hidden in BWD_SHAPES for gh in (False, True)]
    for label, rows, hidden, gh in bwd:
        out.append(with_tail(_ex_bwd, label,
                             dict(rows=rows, hidden=hidden, with_gh=gh),
                             dict(rows=rows + 5, hidden=hidden + 8,
                                  with_gh=gh)))
    return out
