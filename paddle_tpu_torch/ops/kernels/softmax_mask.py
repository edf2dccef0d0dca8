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

What bounds it on the H100: bytes (the causal forward needs only x's
lower triangle). :func:`plan` gives each launch its shape from the shapes
alone, and the C entry launches the grid and shared memory it gives: up
to Sk 8192 a row lies in the registers of a group of lanes (part of a
warp, a warp, or up to 8 warps) and max and sum are shuffles; bf16 rows
reach the registers through a per-lane ring in shared memory. A padding
mask that does not vary over heads is staged once a (b, q) in shared
memory and a block sweeps the heads (a mask constant over batches: the
batches); a causal row reads only its live columns and a group takes rows
q and Sq - 1 - q. Those two take several rows a group, and a group's next
row is in flight while it reduces one; a mask a row and the backward take
one row a group and prefetch nothing, nor do f32 rows. Past Sk 8192 a
block takes a row, in shared memory. The kernel reads the
mask through the strides of its
broadcast view, 0 on every broadcast axis, so the head axis is folded and
never materialised, as JAX's index map folds it (``i // heads``, :80). JAX
sends a mask that is not ``[B|1, 1, Sq|1, Sk|1]`` to its composite
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
import functools
import math
from typing import NamedTuple

import torch

from . import _build

__all__ = ["softmax_mask", "softmax_mask_tri", "softmax_mask_bwd",
           "softmax_mask_plain", "softmax_mask_tri_plain",
           "softmax_mask_bwd_plain", "SoftmaxMaskFunction",
           "SoftmaxMaskTriFunction", "reduce_to_mask", "Plan", "plan",
           "tri_elements", "accepts"]

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 3 \
    + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] \
    + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
#: shared memory a block may take (of 227 KB), less the static part
_SMEM = 227 * 1024 - 1024
#: the register path's widest row: 8 warps of 32 lanes, 4 vectors of 8 a
#: lane; wider rows take the shared-memory path
REG_MAX_SK = 8192
#: the C entry's modes: a block sweeps the heads (a mask constant over
#: heads) or the batches (constant over batches); a mask a row; causal
_MODES = {"sweep": 0, "mask": 1, "tri": 2, "sweepb": 3}


class Plan(NamedTuple):
    """One launch: ``path`` "regs" or "smem"; on the register path a row's
    group of ``lanes`` lanes (a power of two up to 32) times ``warps``
    warps, ``vpl`` 8-element vectors a lane, ``stages`` rows in a group's
    ring (2 where a group takes more than one row, else 1); ``threads`` a
    block, ``groups`` a block, ``blocks`` and dynamic shared memory
    ``smem``: the launch the C entry makes."""
    path: str
    lanes: int
    warps: int
    vpl: int
    threads: int
    stages: int
    groups: int
    blocks: int
    smem: int


@functools.lru_cache(maxsize=None)
def plan(kind, b, h, sq, sk, x_bytes=2, m_bytes=2):
    """The launch of ``kind`` ("sweep": the masked forward with a mask
    constant over heads; "sweepb": over batches; "mask": with any other;
    "tri": causal; "bwd") at scores ``[b, h, sq, sk]`` of ``x_bytes`` an
    element (a mask of ``m_bytes``), a pure function of the shapes.

    A group takes one row (a mask that varies over batches and heads, the
    backward), a causal pair of rows q and Sq - 1 - q, or in a sweep about
    three of the heads (or batches) of its block; rows a group 1, 2, 4, 8,
    causal pairs a group 1, 2, 4 and sweep rows a group 1-6 were timed on
    the card, and these were the fastest or within noise."""
    rows = b * h * sq
    vecs = sk // 8
    if sk > REG_MAX_SK:
        return Plan("smem", 0, 0, 0, _threads(sk), 0, 1, rows,
                    (8 if kind == "bwd" else 4) * sk)
    if vecs <= 32:
        lanes, warps, vpl = 1 << max(0, vecs - 1).bit_length(), 1, 1
    else:
        lanes, warps = 32, -(-vecs // 128)
        vpl = next(v for v in (1, 2, 4) if 32 * warps * v >= vecs)
    if warps > 1:
        threads = 32 * warps
    elif kind in ("sweep", "sweepb"):   # about 3 rows a group
        per_block = -(-(h if kind == "sweep" else b) // 3)
        threads = 32 * min(8, -(-per_block * lanes // 32))
    else:
        threads = 128
    groups = 1 if warps > 1 else threads // lanes
    # 16-byte ring words a lane's vector: x's (and the mask's, or dy's)
    words = {"bwd": 2, "mask": 1 + m_bytes // 2}.get(kind, 1)
    fixed = 4 * sk if kind in ("sweep", "sweepb") else 0
    if kind in ("sweep", "sweepb"):     # a block a (b, q), or an (h, q)
        swept = h if kind == "sweep" else b
        blocks, n = (b if kind == "sweep" else h) * sq, -(-swept // groups)
    else:                               # a group a pair, or a row
        items = b * h * (-(-sq // 2)) if kind == "tri" else rows
        blocks, n = -(-items // groups), 2 if kind == "tri" else 1
    stages = min(2, n)
    smem = fixed + (stages * vpl * threads * 16 * words if x_bytes == 2
                    else 0)
    return Plan("regs", lanes, warps, vpl, threads, stages, groups, blocks,
                smem)


def accepts(sk, kind):
    """Whether the card path takes rows of ``sk`` keys (the same rule for
    both paths): ``Sk % 8 == 0`` and the shared-memory path's rows fit."""
    return sk % 8 == 0 and (8 if kind == "bwd" else 4) * sk <= _SMEM


def tri_elements(sq, sk):
    """The elements of one ``[sq, sk]`` score matrix that the causal
    softmax reads: the lower triangle, ``sum over q of min(q + 1, sk)``."""
    full = max(0, sq - sk)
    part = sq - full
    return part * (part + 1) // 2 + full * sk


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


def _kernel_checks(x, what, kind):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"{what} kernel takes scores [B, H, Sq, Sk], got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{what} kernel takes bf16 or f32, got {x.dtype}")
    sk = x.shape[-1]
    if not accepts(sk, kind):
        raise ValueError(f"{what} kernel needs Sk % 8 == 0 and "
                         f"{8 if kind == 'bwd' else 4} * Sk <= {_SMEM} bytes "
                         f"of shared memory, got Sk {sk}")
    if x.numel() // max(sk, 1) >= 2 ** 31:
        raise ValueError(f"{what}: {x.numel() // sk} rows past the kernel's "
                         f"grid")


def _forward(x, mask, what):
    _kernel_checks(x, what, "fwd")
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
    kind, strides = _fwd_kind(x, mask)
    mask_f32, mvec = 1, 0
    if mask is not None:
        mask_f32 = int(mask.dtype == torch.float32)
        mvec = int(strides[3] == 1 and not any(v % 8 for v in strides[:3])
                   and mask.data_ptr() % 16 == 0)
    p = plan(kind, b, h, sq, sk, x.element_size(),
             4 if mask is None else mask.element_size())
    fn = _build.function("softmax_mask", "ptt_softmax_mask", _ARGS)
    err = fn(x.data_ptr(), None if mask is None else mask.data_ptr(),
             y.data_ptr(), b * h * sq, h, sq, sk, *strides,
             int(x.dtype == torch.float32), mask_f32, _MODES[kind], mvec,
             p.lanes, p.warps, p.vpl, p.threads, p.stages, p.blocks, p.smem,
             stream)
    _build.check(err, what)


def _fwd_kind(x, mask):
    """(plan kind, the mask's strides in its broadcast view, 0 on every
    broadcast axis)."""
    if mask is None:
        return "tri", (0, 0, 0, 0)
    strides = mask.expand(x.shape).stride()
    if strides[1] == 0 and x.shape[1] > 1:
        return "sweep", strides
    if strides[0] == 0 and x.shape[0] > 1:
        return "sweepb", strides
    return "mask", strides


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
    _kernel_checks(y, "softmax_mask backward", "bwd")
    y, dy = y.contiguous(), dy.contiguous()
    dx = torch.empty_like(y)
    _build.require_aligned("softmax_mask backward", y, dy, dx)
    _launch_bwd(y, dy, dx, _build.stream_of(y))
    softmax_mask_bwd.launches += 1
    return dx


softmax_mask_bwd.launches = 0


def _launch_bwd(y, dy, dx, stream):
    """The backward's C entry on operands the caller allocated."""
    b, h, sq, sk = y.shape
    p = plan("bwd", b, h, sq, sk, y.element_size())
    fn = _build.function("softmax_mask", "ptt_softmax_mask_bwd", _BWD_ARGS)
    err = fn(y.data_ptr(), dy.data_ptr(), dx.data_ptr(), b * h * sq, sk,
             int(y.dtype == torch.float32), p.lanes, p.warps, p.vpl,
             p.threads, p.blocks, p.smem, stream)
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


def _rows_of(p, kind, b, h, sq):
    """``bx -> [rows of x]`` that block ``bx`` of plan ``p`` takes."""
    rows = b * h * sq
    if p.path == "smem":
        return lambda bx: [bx]
    if kind == "sweep":
        return lambda bx: [(bx // sq * h + hh) * sq + bx % sq
                           for hh in range(h)]
    if kind == "sweepb":
        return lambda bx: [(bb * h + bx // sq) * sq + bx % sq
                           for bb in range(b)]
    if kind == "tri":
        pairs = -(-sq // 2)

        def tri(bx):
            out = []
            for g in range(bx * p.groups, (bx + 1) * p.groups):
                if g < b * h * pairs:
                    bh, i = divmod(g, pairs)
                    out += sorted({bh * sq + i, bh * sq + sq - 1 - i})
            return out
        return tri
    return lambda bx: list(range(bx * p.groups,
                                 min(rows, (bx + 1) * p.groups)))


def _ex(label, b, h, sq, sk, kind, dtype=torch.bfloat16):
    """One call at scores ``[b, h, sq, sk]``; ``kind``: "mask" with a [B, 1,
    Sq, Sk] padding mask (the sweep over heads), "head" with a mask that
    varies over heads ([1, H, Sq, Sk]: the sweep over batches), "full" with
    a [B, H, Sq, Sk] mask (copied with each row), "tri" the causal
    triangle, or "bwd". The declared maps: each block's rows of the output;
    its reads of x (the causal rows' live vectors only) and of the mask (a
    sweep's block one mask row for all its rows)."""
    from ._examples import CTYPE, fixed, model, normal
    m = model()
    shape = (b, h, sq, sk)
    rows = b * h * sq
    n = rows * sk
    ct = CTYPE[dtype]
    pk = {"mask": "sweep", "head": "sweepb", "full": "mask"}.get(kind, kind)
    p = plan(pk, b, h, sq, sk, dtype.itemsize, 4 if kind == "tri" else 2)
    rows_of = _rows_of(p, pk, b, h, sq)

    def row_map(name):
        if p.path == "smem" or pk in ("mask", "bwd"):   # consecutive rows
            return m.rows_map(name, rows, sk, 1 if p.path == "smem"
                              else p.groups)
        return m.TileMap(name, (1, sk), lambda bx, by, bz: [
            (r, 0) for r in rows_of(bx)], view=(rows, sk))

    if kind == "bwd":
        ops = [m.Operand("y", shape, dtype), m.Operand("dy", shape, dtype),
               m.Operand("dx", shape, dtype, "out")]

        def prepare(t):
            t["y"] = torch.softmax(t["y"].float() * 3.0, -1).to(dtype)

        def plain(t):
            return {"dx": softmax_mask_bwd_plain(t["y"], t["dy"])}

        def launch(t, stream):
            _launch_bwd(t["y"], t["dy"], t["dx"], stream)

        name = f"softmax_mask_bwd_smem_kernel<{ct}>" if p.path == "smem" \
            else f"softmax_mask_bwd_kernel<{ct},{p.vpl}>"
        kern = m.KernelLaunch(name, p.blocks, p.threads, smem=p.smem,
                              writes=[row_map("dx")],
                              reads=[row_map("y"), row_map("dy")])
        return m.Example(label, "softmax_mask", ops, [kern], launch, plain,
                         flops=4 * n, nbytes=3 * n * dtype.itemsize,
                         prepare=prepare)
    ops = [m.Operand("x", shape, dtype, data=normal(shape, dtype, 3.0)),
           m.Operand("y", shape, dtype, "out")]
    reads = [row_map("x")]
    read_elems, mask_bytes = n, 0
    if kind == "mask":
        mk = pad_mask(b, sk, seed=91)[:, :, :sq]
        ops.append(m.Operand("mask", tuple(mk.shape), torch.bfloat16,
                             data=fixed(mk)))
        mask_bytes = mk.numel() * 2
        if p.path == "regs":
            reads.append(m.TileMap("mask", (1, sk),
                                   lambda bx, by, bz: (bx, 0),
                                   view=(b * sq, sk)))
    elif kind in ("head", "full"):
        mshape = (1 if kind == "head" else b, h, sq, sk)
        ops.append(m.Operand("mask", mshape, torch.bfloat16,
                             data=normal(mshape, torch.bfloat16, 2.0)))
        mask_bytes = math.prod(mshape) * 2
        if kind == "head" and p.path == "regs":
            reads.append(m.TileMap("mask", (1, sk),
                                   lambda bx, by, bz: (bx, 0),
                                   view=(h * sq, sk)))
        else:
            reads.append(m.TileMap("mask", (1, sk), lambda bx, by, bz: [
                (r % (mshape[0] * h * sq), 0) for r in rows_of(bx)],
                view=(mshape[0] * h * sq, sk)))
    elif kind == "tri":
        read_elems = b * h * tri_elements(sq, sk)

        def live(r):
            return -(-min(r % sq + 1, sk) // 8)
        # a row's live vectors: whole 64-column tiles, then 8-column ones
        reads = [m.TileMap("x", (1, 64), lambda bx, by, bz: [
            (r, c) for r in rows_of(bx) for c in range(live(r) // 8)],
            view=(rows, sk)),
            m.TileMap("x", (1, 8), lambda bx, by, bz: [
                (r, c) for r in rows_of(bx)
                for c in range(live(r) // 8 * 8, live(r))],
                view=(rows, sk))]

    def plain(t):
        if kind == "tri":
            return {"y": softmax_mask_tri_plain(t["x"])}
        return {"y": softmax_mask_plain(t["x"], t["mask"])}

    def launch(t, stream):
        _launch_fwd(t["x"], t.get("mask"), t["y"], label, stream)

    mt = "float" if kind == "tri" else "__nv_bfloat16"
    if p.path == "smem":
        name = f"softmax_mask_smem_kernel<{ct},{mt}," \
               f"{str(kind == 'tri').lower()}>"
    else:
        mode = 0 if pk.startswith("sweep") else _MODES[pk]   # template MODE
        name = f"softmax_mask_kernel<{ct},{mt},{mode},{p.vpl}>"
    kern = m.KernelLaunch(name, p.blocks, p.threads, smem=p.smem,
                          writes=[row_map("y")], reads=reads)
    return m.Example(label, "softmax_mask", ops, [kern], launch, plain,
                     flops=6 * read_elems,
                     nbytes=(read_elems + n) * dtype.itemsize + mask_bytes)


def ck_examples():
    """At ``softmax_mask_pallas.pk_examples``' shapes (16 heads of [512,
    512] scores as [2, 8, 512, 512], a [2, 1, 512, 512] mask) and phase 3's
    (GPT-2 small's [8, 12, 1024, 1024] with a padding mask, causal, and the
    backward; the incubate micro-batch's [4, 12, 1024, 1024] causal and
    backward; causal [2, 32, 2048, 2048]); masks that vary over heads, and
    over batches and heads;
    rows past the register path (Sk 16384); tails with a key length that
    leaves lanes idle and an odd row count."""
    from ._examples import with_tail
    out = []
    tail = dict(b=1, h=3, sq=1000, sk=1000)
    for label, b, h, s, kind in (
            ("softmax_mask_fwd", 2, 8, 512, "mask"),
            ("softmax_tri_fwd", 2, 8, 512, "tri"),
            ("softmax_bwd", 2, 8, 512, "bwd"),
            ("phase3 [8, 12, 1024, 1024] mask", 8, 12, 1024, "mask"),
            ("phase3 [8, 12, 1024, 1024] causal", 8, 12, 1024, "tri"),
            ("phase3 [4, 12, 1024, 1024] causal", 4, 12, 1024, "tri"),
            ("phase3 [2, 32, 2048, 2048] causal", 2, 32, 2048, "tri"),
            ("phase3 bwd [8, 12, 1024, 1024]", 8, 12, 1024, "bwd"),
            ("phase3 bwd [4, 12, 1024, 1024]", 4, 12, 1024, "bwd")):
        out.append(with_tail(_ex, label, dict(b=b, h=h, sq=s, sk=s,
                                              kind=kind),
                             dict(tail, kind=kind)))
    for kind in ("head", "full"):
        out.append(with_tail(_ex, f"softmax {kind} mask [2, 4, 64, 256]",
                             dict(b=2, h=4, sq=64, sk=256, kind=kind),
                             dict(b=3, h=3, sq=7, sk=1000, kind=kind)))
    for kind in ("mask", "tri", "bwd"):
        out.append(with_tail(_ex, f"softmax wide [1, 2, 3, 16384] {kind}",
                             dict(b=1, h=2, sq=3, sk=16384, kind=kind),
                             dict(b=1, h=1, sq=3, sk=16392, kind=kind)))
    return out
