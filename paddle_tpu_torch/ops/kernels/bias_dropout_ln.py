"""Bias + dropout + residual add + layer norm: the CUDA kernels (forward
and backward), the plain versions and the autograd Function.

Replaces ``paddle_tpu/ops/kernels/bias_dropout_ln_pallas.py``
``_fused_fwd`` (:96; kernel body ``_fwd_kernel`` :45) and ``_fused_bwd``
(:125; kernel body ``_bwd_kernel`` :64), with the custom_vjp
``bias_dropout_ln`` (:158-206). Source:
``paddle_tpu_torch/csrc/bias_dropout_ln.cu``.

Per row of ``[N, H]``::

    h = (x + bias) * mask + residual          (mask None: no product)
    y = (h - mean(h)) * rsqrt(var(h) + eps) * gamma + beta

with the mean and ``var = mean((h - mu)**2)`` in f32, ``x_hat * gamma +
beta`` in f32, and ``y`` and ``h`` each rounded once to ``x.dtype``. (The
port's ``nn.functional.layer_norm`` rounds ``x_hat`` first, as JAX's
composite does; this is the kernel's rounding, so it has its own plain
version.) The mask is f32 with values ``keep / (1 - p)``, drawn outside
the kernel; ``mask=None`` is the maskless variant, which reads no mask.

The backward recomputes the statistics from the saved ``h`` in
``x.dtype``, not from the forward's f32 sum, as JAX's does, and so does
the plain version: ``u = dy * gamma``, ``dh = (u - mean(u) - x_hat *
mean(u * x_hat)) * rstd``, ``dx = dh * mask``, ``dres = dh``, and f32 sums
over the rows ``dgamma = sum dy * x_hat``, ``dbeta = sum dy``, ``dbias =
sum dh * mask``. A cotangent on ``h`` joins after the kernel in plain
tensor code, in JAX's order and types (:191-200).

What bounds it on the H100: bytes. :func:`plan` gives each launch its
shape from the shapes alone, and the C entries launch exactly that. The
forward takes a block a row, one vector of 8 a thread. The backward's row
lies in the registers of a group of lanes (part of a warp, or whole warps;
one vector of 8 a lane, two past H 6144), its sums by shuffles and,
across warps, a named barrier of the group's own; one block an SM, group
g of G walking rows g, g + G, ... with gamma in registers; the group's
first lane copies its next row whole into a ring of two stages in shared
memory (bulk copies on an mbarrier a stage) while the group works on one.
The backward's blocks each write one partial row of each sum, and a
second small kernel adds them in a fixed order (one wrapper call, one
launch in the count). ``H % 8 == 0`` and ``H <= 8192``; bf16 or f32 rows
(x, residual of one type); the vectors bf16 or f32 as they come (all three
of one type, else cast to f32), the mask cast to f32 by the wrapper. A
CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

__all__ = ["bias_dropout_ln", "bias_dropout_ln_plain", "bias_dropout_ln_bwd",
           "bias_dropout_ln_bwd_plain", "BiasDropoutLNFunction",
           "MAX_HIDDEN", "Plan", "plan", "declared_bytes"]

MAX_HIDDEN = 8192
# rows, hidden, eps, is_f32, vec_f32, then the plan's launch and the stream
_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_float] + [ctypes.c_int] * 8 \
    + [ctypes.c_void_p]
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
#: the H100's SMs. The backward: vectors of 8 a lane at most one up to this
#: many a row, two past it; a block an SM of at most 768 threads at one
#: vector a lane and 512 at two (the kernel's ``__launch_bounds__``: 80 and
#: 128 registers a thread); named barriers for groups of several warps;
#: shared memory a block may take (of 227 KB, less the static reduction
#: scratch); threads a block aims at (8 groups of 3 warps at H 768); the
#: stages of a group's ring (the row it works on and the next)
_SMS, _ONE_VECTOR_MAX = 132, 768
_MAX_THREADS = {1: 768, 2: 512}
_MAX_BARRIER_GROUPS = 15
_SMEM = 227 * 1024 - 1024
_AIM_THREADS, _STAGES = 768, 2


class Plan(NamedTuple):
    """One launch: a row's group of ``lanes`` lanes (a power of two up to
    32) times ``warps`` warps, ``vpl`` 8-element vectors a lane (1, or 2
    past 768 vectors a row); ``groups`` groups a block of ``threads``,
    ``blocks`` and dynamic shared memory ``smem``: the launch the C entry
    makes. The forward's is a block a row (one group of whole warps, one
    vector a lane, no shared memory); the backward's at most a block an SM
    (its partial rows)."""
    lanes: int
    warps: int
    vpl: int
    groups: int
    threads: int
    blocks: int
    smem: int


def _smem(hidden, itemsize, masked, groups, width):
    """Shared memory the backward kernel addresses (the C entry's
    ``checked``): the ring (``groups`` x 2 stages of two rows of
    ``itemsize`` bytes an element and the f32 mask), or the block's three
    combined partial rows where they are larger and the block holds more
    than one warp (or group of ``width`` lanes, if wider); then 8 bytes of
    mbarrier a stage."""
    ring = groups * _STAGES * hidden * (2 * itemsize + 4 * masked)
    comb = 12 * hidden if groups * width > max(32, width) else 0
    return max(ring, comb) + 8 * groups * _STAGES


@functools.lru_cache(maxsize=None)
def plan(kind, rows, hidden, itemsize=2, masked=True):
    """The launch of ``kind`` ("fwd" or "bwd") at rows ``[rows, hidden]``
    of ``itemsize`` bytes an element, with or without the f32 mask: a pure
    function of the shapes.

    Forward: a block a row, the fewest whole warps that give each vector
    of 8 a thread (H 768: 3 warps; H 8192: 32).

    Backward: a row's group is, up to 32 vectors, the fewest lanes (a
    power of two) with one vector each; up to 768 vectors whole warps of
    one vector a lane (H 768: 3 warps; H 4096: 16); past that warps of two
    (H 8192: 16). A block holds the number of groups nearest 768 threads
    (at most 768 threads, or 512 at two vectors a lane, and 15 groups of
    several warps: a named barrier each), and no more than it takes to
    spread the rows over the SMs, with fewer groups where their rings do
    not fit; one block an SM, at most as many blocks as give every group a
    row."""
    vecs = hidden // 8
    if kind == "fwd":
        warps = max(1, -(-vecs // 32))
        return Plan(32, warps, 1, 1, 32 * warps, rows, 0)
    vpl = 1 if vecs <= _ONE_VECTOR_MAX else 2
    if vecs <= 32:
        lanes, warps = 1 << max(0, vecs - 1).bit_length(), 1
    else:
        lanes, warps = 32, -(-vecs // (32 * vpl))
    width = lanes * warps
    least = max(1, 32 // width)         # a block holds whole warps
    groups = max(1, min(_MAX_THREADS[vpl] // width,
                        (_AIM_THREADS + width // 2) // width))
    if warps > 1:
        groups = min(groups, _MAX_BARRIER_GROUPS)
    # few rows: spread them over the SMs
    groups = min(groups, -(-(-(-rows // _SMS)) // least) * least)

    def need(g):
        return _smem(hidden, itemsize, masked, g, width)
    while groups > least and need(groups) > _SMEM:
        groups -= least
    blocks = max(1, min(_SMS, -(-rows // groups)))
    return Plan(lanes, warps, vpl, groups, groups * width, blocks,
                need(groups))


def _check_vecs(hd, dev, *vecs):
    for t in vecs:
        if t.shape != (hd,):
            raise ValueError(f"bias_dropout_ln: vectors must be [{hd}], got "
                             f"{tuple(t.shape)}")
        if t.device != dev:
            raise ValueError("bias_dropout_ln: operands on different devices")


def _check(x, bias, residual, mask, gamma, beta):
    if not (x.is_floating_point() and residual.is_floating_point()):
        raise TypeError(f"bias_dropout_ln takes floating tensors, got "
                        f"{x.dtype} / {residual.dtype}")
    if residual.shape != x.shape or residual.device != x.device:
        raise ValueError(f"bias_dropout_ln: residual {tuple(residual.shape)} "
                         f"must match x {tuple(x.shape)}")
    if mask is not None and (mask.shape != x.shape
                             or mask.device != x.device):
        raise ValueError(f"bias_dropout_ln: mask {tuple(mask.shape)} must "
                         f"match x {tuple(x.shape)}")
    _check_vecs(x.shape[-1], x.device, bias, gamma, beta)


def _stats(hf, eps):
    mu = hf.mean(-1, keepdim=True)
    var = ((hf - mu) * (hf - mu)).mean(-1, keepdim=True)
    return mu, torch.rsqrt(var + eps)


def bias_dropout_ln_plain(x, bias, residual, mask, gamma, beta, eps):
    """``(y, h)`` in plain PyTorch, the kernel's arithmetic
    (``reference_bias_dropout_ln``, :209-216; maskless with
    ``mask=None``)."""
    _check(x, bias, residual, mask, gamma, beta)
    h = x.float() + bias.float()
    if mask is not None:
        h = h * mask.float()
    h = h + residual.float()
    mu, rstd = _stats(h, eps)
    y = (h - mu) * rstd * gamma.float() + beta.float()
    return y.to(x.dtype), h.to(x.dtype)


def bias_dropout_ln(x, bias, residual, mask, gamma, beta, eps):
    """``(y, h)``, as :func:`bias_dropout_ln_plain`. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises."""
    _check(x, bias, residual, mask, gamma, beta)
    if x.device.type == "cpu":
        return bias_dropout_ln_plain(x, bias, residual, mask, gamma, beta,
                                     eps)
    hd = _kernel_checks(x, residual, "bias_dropout_ln")
    x, residual = x.contiguous(), residual.contiguous()
    bias, gamma, beta = _vectors(bias, gamma, beta)
    if mask is not None:
        mask = mask.float().contiguous()
    y, h = torch.empty_like(x), torch.empty_like(x)
    _build.require_aligned("bias_dropout_ln", x, residual, mask, y, h, bias,
                           gamma, beta)
    _launch_fwd(x, bias, residual, mask, gamma, beta, y, h, eps,
                _build.stream_of(x))
    bias_dropout_ln.launches += 1
    return y, h


bias_dropout_ln.launches = 0


def _vectors(*vecs):
    """The vectors as the kernels read them: all bf16 or all f32 as they
    come (converted to f32 in the kernel, as ``.float()`` does), else all
    cast to f32; contiguous and 16-byte aligned (a copy where not)."""
    dt = vecs[0].dtype
    if dt not in _KERNEL_DTYPES or any(v.dtype != dt for v in vecs):
        vecs = [v.float() for v in vecs]
    vecs = [v.contiguous() for v in vecs]
    return [v.clone() if v.data_ptr() % 16 else v for v in vecs]


def _launch_fwd(x, bias, residual, mask, gamma, beta, y, h, eps, stream):
    """The forward's C entry on operands the caller allocated (vectors of
    one type, bf16 or f32; the mask f32)."""
    hd = x.shape[-1]
    rows = x.numel() // hd
    p = plan("fwd", rows, hd, x.element_size(), mask is not None)
    fn = _build.function("bias_dropout_ln", "ptt_bias_dropout_ln", _ARGS)
    err = fn(x.data_ptr(), bias.data_ptr(), residual.data_ptr(),
             None if mask is None else mask.data_ptr(), gamma.data_ptr(),
             beta.data_ptr(), y.data_ptr(), h.data_ptr(), rows, hd,
             float(eps), int(x.dtype == torch.float32),
             int(gamma.dtype == torch.float32), p.threads, stream)
    _build.check(err, "bias_dropout_ln")


def _c_plan(p):
    """The backward's plan as its C entry takes it."""
    return (p.lanes, p.warps, p.vpl, p.threads, p.blocks, p.smem)


def _kernel_checks(x, other, what):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    if x.dtype not in _KERNEL_DTYPES or other.dtype != x.dtype:
        raise TypeError(f"{what} kernel takes bf16 or f32 rows of one type, "
                        f"got {x.dtype} / {other.dtype}")
    hd = x.shape[-1]
    if hd % 8 or hd > MAX_HIDDEN:
        raise ValueError(f"{what} kernel needs hidden % 8 == 0 and hidden <= "
                         f"{MAX_HIDDEN}, got {hd}")
    if x.numel() // hd >= 2 ** 31:
        raise ValueError(f"{what}: {x.numel() // hd} rows past the kernel's "
                         f"range")
    return hd


def _check_bwd(h, mask, gamma, dy):
    if dy.shape != h.shape or dy.dtype != h.dtype or dy.device != h.device:
        raise ValueError(f"bias_dropout_ln backward: dy {dy.dtype} "
                         f"{tuple(dy.shape)} must match h {h.dtype} "
                         f"{tuple(h.shape)}")
    if mask is not None and (mask.shape != h.shape
                             or mask.device != h.device):
        raise ValueError(f"bias_dropout_ln backward: mask "
                         f"{tuple(mask.shape)} must match h {tuple(h.shape)}")
    _check_vecs(h.shape[-1], h.device, gamma)


def bias_dropout_ln_bwd_plain(h, mask, gamma, dy, eps):
    """``(dx, dres, dgamma, dbeta, dbias)`` in plain PyTorch (the formulas
    of ``_bwd_kernel``, :64-93), the statistics recomputed from the saved
    ``h``; ``dx`` and ``dres`` in h's dtype, the sums f32."""
    _check_bwd(h, mask, gamma, dy)
    hd = h.shape[-1]
    hf = h.reshape(-1, hd).float()
    dyf = dy.reshape(-1, hd).float()
    mu, rstd = _stats(hf, eps)
    xhat = (hf - mu) * rstd
    u = dyf * gamma.float()
    c1 = u.mean(-1, keepdim=True)
    c2 = (u * xhat).mean(-1, keepdim=True)
    dh = (u - c1 - xhat * c2) * rstd
    dm = dh * mask.reshape(-1, hd).float() if mask is not None else dh
    return (dm.to(h.dtype).reshape(h.shape), dh.to(h.dtype).reshape(h.shape),
            (dyf * xhat).sum(0), dyf.sum(0), dm.sum(0))


def bias_dropout_ln_bwd(h, mask, gamma, dy, eps):
    """``(dx, dres, dgamma, dbeta, dbias)``, as
    :func:`bias_dropout_ln_bwd_plain`; the same dispatch as
    :func:`bias_dropout_ln`."""
    _check_bwd(h, mask, gamma, dy)
    if h.device.type == "cpu":
        return bias_dropout_ln_bwd_plain(h, mask, gamma, dy, eps)
    hd = _kernel_checks(h, dy, "bias_dropout_ln backward")
    h, dy = h.contiguous(), dy.contiguous()
    (g,) = _vectors(gamma)
    if mask is not None:
        mask = mask.float().contiguous()
    rows = h.numel() // hd
    p = plan("bwd", rows, hd, h.element_size(), mask is not None)
    dx, dres = torch.empty_like(h), torch.empty_like(h)
    part = torch.empty(3, p.blocks, hd, dtype=torch.float32, device=h.device)
    # no rows, no block: the sums are zero
    out = (torch.zeros if rows == 0 else torch.empty)(
        3, hd, dtype=torch.float32, device=h.device)
    _build.require_aligned("bias_dropout_ln backward", h, dy, mask, g, dx,
                           dres, part)
    _launch_bwd(h, mask, g, dy, dx, dres, part, out, eps, _build.stream_of(h))
    bias_dropout_ln_bwd.launches += 1
    return dx, dres, out[0], out[1], out[2]


bias_dropout_ln_bwd.launches = 0


def _launch_bwd(h, mask, gamma, dy, dx, dres, part, out, eps, stream):
    """The backward's C entry (the rows kernel, then the fixed-order sum of
    its partials) on operands the caller allocated."""
    hd = h.shape[-1]
    rows = h.numel() // hd
    p = plan("bwd", rows, hd, h.element_size(), mask is not None)
    fn = _build.function("bias_dropout_ln", "ptt_bias_dropout_ln_bwd",
                         _BWD_ARGS)
    err = fn(h.data_ptr(), None if mask is None else mask.data_ptr(),
             gamma.data_ptr(), dy.data_ptr(), dx.data_ptr(), dres.data_ptr(),
             part.data_ptr(), out.data_ptr(), rows, hd, float(eps),
             int(h.dtype == torch.float32),
             int(gamma.dtype == torch.float32), *_c_plan(p), stream)
    _build.check(err, "bias_dropout_ln backward")


# -- declared launches for the kernel analyzer -------------------------------

def dropout_scale_mask(rows, hd, p, seed):
    """A kept-and-scaled f32 mask ``[rows, hd]`` on the CPU: 1 / (1 - p)
    where kept, 0 where dropped, from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    keep = torch.rand(rows, hd, generator=gen) >= p
    return keep.float() / (1.0 - p)


def _rows_of(p, rows):
    """``bx -> [rows]`` that block ``bx`` of plan ``p`` takes: its groups'
    rows g, g + G, g + 2G, ... (G the groups of the grid)."""
    stride = p.blocks * p.groups
    return lambda bx: [r for g in range(bx * p.groups, (bx + 1) * p.groups)
                       for r in range(g, rows, stride)]


def declared_bytes(kind, rows, hd, itemsize, masked):
    """The bytes a call must move: each row operand read or written once
    in its own type (x and res read, y and h written; h and dy read, dx
    and dres written), the f32 mask read once, and the f32 vectors (bias,
    gamma, beta read; gamma read and the three sums written)."""
    return rows * hd * (4 * itemsize + 4 * masked) + (12 if kind == "fwd"
                                                      else 16) * hd


def _ex(label, rows, hd, masked, bwd, dtype=torch.bfloat16):
    """Forward: a block a row (y and h; reads of x, res, the mask and the
    vectors). Backward: each block's groups take their rows (dx, dres;
    reads of h, dy, the mask, and of gamma once a lane), one f32 partial
    row of each of the three sums a block, at most one block an SM; then a
    second kernel sums the partials column by column in a fixed order into
    [3, hidden]."""
    from ._examples import CTYPE, fixed, model, normal
    m = model()
    f32 = torch.float32
    kind = "bwd" if bwd else "fwd"
    p = plan(kind, rows, hd, dtype.itemsize, masked)
    rows_of = _rows_of(p, rows)

    def row_map(name):
        return m.TileMap(name, (1, hd), lambda bx, by, bz: [
            (r, 0) for r in rows_of(bx)], view=(rows, hd))

    ops = [m.Operand("gamma", (hd,), f32, data=normal((hd,), f32, 0.1, 1.0))]
    vec_reads = [m.whole_map("gamma", (hd,))]
    if masked:
        mk = dropout_scale_mask(rows, hd, 0.1, seed=5)
        ops.append(m.Operand("mask", (rows, hd), f32, data=fixed(mk)))
    n = rows * hd
    targs = f"<{CTYPE[dtype]},{str(masked).lower()}"
    nbytes = declared_bytes(kind, rows, hd, dtype.itemsize, masked)
    if not bwd:
        ops += [m.Operand("x", (rows, hd), dtype),
                m.Operand("res", (rows, hd), dtype),
                m.Operand("bias", (hd,), f32, data=normal((hd,), f32, 0.1)),
                m.Operand("beta", (hd,), f32, data=normal((hd,), f32, 0.1)),
                m.Operand("y", (rows, hd), dtype, "out"),
                m.Operand("h", (rows, hd), dtype, "out")]

        def plain(t):
            y, h = bias_dropout_ln_plain(t["x"], t["bias"], t["res"],
                                         t.get("mask"), t["gamma"],
                                         t["beta"], 1e-5)
            return {"y": y, "h": h}

        def launch(t, stream):
            _launch_fwd(t["x"], t["bias"], t["res"], t.get("mask"),
                        t["gamma"], t["beta"], t["y"], t["h"], 1e-5, stream)

        kern = m.KernelLaunch(
            "bias_dropout_ln_kernel" + targs + ">", p.blocks, p.threads,
            writes=[row_map("y"), row_map("h")],
            reads=[row_map("x"), row_map("res")]
            + ([row_map("mask")] if masked else []) + vec_reads
            + [m.whole_map("bias", (hd,)), m.whole_map("beta", (hd,))])
        return m.Example(label, "bias_dropout_ln", ops, [kern], launch, plain,
                         flops=n * (10 + masked), nbytes=nbytes)
    ops += [m.Operand("h", (rows, hd), dtype), m.Operand("dy", (rows, hd), dtype),
            m.Operand("dx", (rows, hd), dtype, "out"),
            m.Operand("dres", (rows, hd), dtype, "out"),
            m.Operand("part", (3, p.blocks, hd), f32, "out"),
            m.Operand("out", (3, hd), f32, "out")]

    def plain(t):
        dx, dres, dg, db, dbias = bias_dropout_ln_bwd_plain(
            t["h"], t.get("mask"), t["gamma"], t["dy"], 1e-5)
        return {"dx": dx, "dres": dres, "out": torch.stack([dg, db, dbias])}

    def launch(t, stream):
        _launch_bwd(t["h"], t.get("mask"), t["gamma"], t["dy"], t["dx"],
                    t["dres"], t["part"], t["out"], 1e-5, stream)

    kernels = [
        m.KernelLaunch("bias_dropout_ln_bwd_kernel" + targs + f",{p.vpl}>",
                       p.blocks, p.threads, smem=p.smem,
                       writes=[row_map("dx"), row_map("dres"),
                               m.TileMap("part", (1, 1, hd), lambda x, y, z: [
                                   (a, x, 0) for a in range(3)])],
                       reads=[row_map("h"), row_map("dy")]
                       + ([row_map("mask")] if masked else []) + vec_reads),
        m.KernelLaunch("bdl_partial_sum_kernel", -(-3 * hd // 32), 256,
                       writes=[m.TileMap("out", (32,), lambda x, y, z: (x,),
                                         view=(3 * hd,))])]
    return m.Example(label, "bias_dropout_ln", ops, kernels, launch, plain,
                     flops=n * (16 + 2 * masked), nbytes=nbytes,
                     tol={"out": 1e-3, "*": 2.0 ** -7})


def ck_examples():
    """At ``bias_dropout_ln_pallas.pk_examples``' shape ([512, 1024]:
    forward maskless and with a mask, the backward with it) and phase 3's
    (GPT-2 small's [8192, 768] with the p = 0.1 mask and maskless, the
    incubate micro-batch's [4096, 768] with it, Llama-3-8B's [4096, 4096]
    with it; forward and backward); tails with a hidden width that leaves
    lanes of the last vectors idle and more rows than groups."""
    from ._examples import with_tail
    out = []
    for label, rows, hd, masked, bwd in (
            ("fused_fwd", 512, 1024, False, False),
            ("fused_fwd_mask", 512, 1024, True, False),
            ("fused_bwd", 512, 1024, True, True)):
        out.append(with_tail(_ex, label, dict(rows=rows, hd=hd, masked=masked,
                                              bwd=bwd),
                             dict(rows=1061, hd=1000, masked=masked,
                                  bwd=bwd)))
    for rows, hd, masked in ((8192, 768, True), (8192, 768, False),
                             (4096, 768, True), (4096, 4096, True)):
        for bwd in (False, True):
            label = (f"phase3 {'bwd ' if bwd else ''}[{rows}, {hd}] "
                     f"{'mask p=0.1' if masked else 'maskless'}")
            out.append(with_tail(_ex, label, dict(rows=rows, hd=hd,
                                                  masked=masked, bwd=bwd),
                                 dict(rows=1061, hd=hd + 8, masked=masked,
                                      bwd=bwd)))
    return out


class BiasDropoutLNFunction(torch.autograd.Function):
    """``(y, h)`` with the backward kernel (the custom_vjp
    ``bias_dropout_ln``, :158-206). ``apply(x, bias, residual, mask, gamma,
    beta, eps, plain)``; it saves ``h``, the mask and ``gamma``. A
    cotangent on ``h`` joins both branches after the kernel as JAX's
    ``_vjp_bwd`` adds it: ``dres += gh`` in h's dtype, ``dx += (gh *
    mask)`` rounded to x's dtype, ``dbias += sum gh * mask`` in f32; the
    vector gradients are cast to ``gamma``'s dtype. The mask gets no
    gradient. ``plain`` runs the plain forward and backward."""

    @staticmethod
    def forward(ctx, x, bias, residual, mask, gamma, beta, eps, plain):
        fwd = bias_dropout_ln_plain if plain else bias_dropout_ln
        y, h = fwd(x, bias, residual, mask, gamma, beta, eps)
        ctx.save_for_backward(h, mask, gamma)
        ctx.eps = eps
        ctx.plain = plain
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, gy, gh):
        h, mask, gamma = ctx.saved_tensors
        if gy is None and gh is None:
            return (None,) * 8
        gy = torch.zeros_like(h) if gy is None else gy.contiguous()
        bwd = bias_dropout_ln_bwd_plain if ctx.plain else bias_dropout_ln_bwd
        dx, dres, dgamma, dbeta, dbias = bwd(h, mask, gamma, gy, ctx.eps)
        if gh is not None:
            hd = h.shape[-1]
            dres = dres + gh
            masked = gh.reshape(-1, hd).float()
            if mask is not None:
                masked = masked * mask.reshape(-1, hd).float()
            dx = dx + masked.reshape(h.shape).to(dx.dtype)
            dbias = dbias + masked.sum(0)
        gd = gamma.dtype
        return (dx, dbias.to(gd), dres, None, dgamma.to(gd), dbeta.to(gd),
                None, None)
