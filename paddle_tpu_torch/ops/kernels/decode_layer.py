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
386 MB of bf16 weights and ~20 MB of keys and values (~0.12 ms at
3.35 TB/s). The TPU kernel keeps the weights resident in VMEM and runs the
layer tail in one grid step per row; on the card that would stream all
weights through one SM per row. The kernel is one persistent cooperative
launch instead, one block of two consumer warpgroups and a producer
warp an SM, whose five phases (attention; o_proj; gate/up and SiLU;
down; the norm) each spread over every SM, separated by barriers of its
own. Attention streams (kv head, row, 64-position) sub-chunks, every query
head of a GQA group at once (keys and values read once), cut into one
contiguous range a block. The three matrix-vector phases run on the tensor
cores with the weight as the wgmma's A (64 rows) and the batch rows as its
N (three bf16 terms of 8, or of 16 past batch 8: each weight byte is read
once at any batch): a producer thread streams the weights through a 10-
or 11-stage TMA ring from the kernel's start, across the barriers, and each
phase's (tile, k) stages are cut into equal ranges, one a block. The f32
activations enter as three bf16 terms each (hi, mid, lo: exact save for an
underflow of lo), so no activation is rounded. A block's partial tiles are
added in block order by the last block to finish each tile, so two calls
on the same inputs give the same bits.

``block_i`` is the MLP's column chunk of the JAX kernel and the one tuned
knob (``ops/kernels/autotune.py`` measures it and installs the winner
under :data:`BLOCK_I_KEY`); the wrapper and the C entry still take and
check it, but the CUDA kernel's gate/up unit is a fixed 64-column tile, so
every legal ``block_i`` runs the same schedule. With nothing installed the
wrapper passes :data:`DEFAULT_BLOCK_I` (clamped by the JAX rule).

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

_ARGS = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 9 + [
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
    if block_i is None:
        block_i = _pick_block_i(i_size)
    block_i = int(block_i)
    if block_i <= 0 or block_i % 8 or i_size % block_i:
        raise ValueError(f"decode_layer: block_i {block_i} must be a "
                         f"multiple of 8 dividing {i_size}")
    _build.require_aligned("decode_layer", *ops)
    if stamps is not None and (stamps.device != q.device or stamps.dtype !=
                               torch.int64 or stamps.shape != (6,)):
        raise ValueError("decode_layer: stamps must be an int64 [6] tensor "
                         "on q's device")
    y = torch.empty_like(hres)
    h_out = torch.empty_like(hres)
    scratch = torch.empty(scratch_floats(b, h_kv, h // h_kv, d, hd, i_size),
                          dtype=torch.float32, device=q.device)
    stream = _build.stream_of(q)
    ctrl = _ctrl(q.device, stream, ctrl_words(b, h_kv, hd, i_size))
    _launch(ops, y, h_out, scratch, ctrl, eps_post, eps_next, block_i, stamps,
            stream)
    decode_layer.launches += 1
    return y, h_out


decode_layer.launches = 0


def scratch_floats(b, h_kv, rep, d, hd, i_size) -> int:
    """f32 scratch the kernel needs on the current device (the C entry's
    own count: its grid is one block an SM)."""
    n = _build.function("decode_layer", "ptt_decode_layer_scratch",
                        [ctypes.c_int] * 6)(b, h_kv, rep, d, hd, i_size)
    if n < 0:
        raise RuntimeError("decode_layer: the scratch size could not be "
                           "computed on this device")
    return n


#: (device index, stream) -> the kernel's counters: zeroed once, left zero
#: by every call (the last block to finish clears them), one buffer a
#: stream so that calls on two streams never share one
_CTRLS: dict = {}


def ctrl_words(b, h_kv, hd, i_size) -> int:
    """uint32 counters the kernel keeps (the source's ``ctrl_words``): four
    barriers, an end count, the pieces of each (row, kv head), the tiles of
    o_proj, gate/up and down."""
    return (_BARRIERS + 1 + b * h_kv + 2 * -(-hd // (2 * _BOX_ROWS))
            + -(-i_size // _BOX_ROWS))


def _ctrl(device, stream, words):
    key = (device.index, stream)
    buf = _CTRLS.get(key)
    if buf is None or buf.numel() < words:
        buf = torch.zeros(max(words, 4096), dtype=torch.int32, device=device)
        _CTRLS[key] = buf
    return buf


def _launch(ops, y, h_out, scratch, ctrl, eps_post, eps_next, block_i, stamps,
            stream):
    """The C entry on operands the caller allocated; ``ops`` is ``(q,
    k_layer, v_layer, tables, pos, hres, wo, w_post, wg, wu, wd,
    w_next)``."""
    q, k_layer, tables, hres, wg = ops[0], ops[1], ops[3], ops[5], ops[8]
    b, h, d = q.shape
    _, h_kv, ps, _ = k_layer.shape
    fn = _build.function("decode_layer", "ptt_decode_layer", _ARGS)
    err = fn(*(t.data_ptr() for t in ops), y.data_ptr(), h_out.data_ptr(),
             scratch.data_ptr(), ctrl.data_ptr(), b, h_kv, h // h_kv, d, ps,
             tables.shape[1],
             hres.shape[1], wg.shape[0], int(block_i), float(eps_post),
             float(eps_next), None if stamps is None else stamps.data_ptr(),
             stream)
    _build.check(err, "decode_layer")


_NAMES = ("q", "k", "v", "tables", "pos", "hres", "wo", "w_post", "wg", "wu",
          "wd", "w_next")


# -- declared launches for the kernel analyzer -------------------------------

#: the source's constants: threads (two consumer warpgroups and a producer
#: warp), consumer threads, k of a weight box, weight rows of a box, bf16
#: terms an activation, attention positions of a sub-chunk, weight stages
#: the producer issues together
_THREADS, _CONS, _BK, _BOX_ROWS, _TERMS, _SUB, _ISSUE = \
    288, 256, 64, 64, 3, 64, 4
_MAX_REP, _BARRIERS = 8, 4
#: the H100's SMs: the grid, one block each
_SMS = 132


def _nb(b):
    """The wgmma's N a term: batch rows padded to 8, or to 16 past 8."""
    return 8 if b <= 8 else 16


def _stages(nb):
    """Ring stages (the source's ``kStagesOf<NB>``): as many as shared
    memory holds."""
    return 11 if nb == 8 else 10


def _smem(d, nb):
    """Dynamic shared memory (the source's ``Layout<D, NB>::smem``): the
    alignment pad, the ring (two [64, 64] weight boxes and the activation
    box [3, NB, 64] a stage; the attention's buffers lie in its last
    stages), the reduction scratch, the row rsqrts, a flag and the
    attention's state, the attention's row counts, offsets and page
    entries, and the ring's mbarriers. ``d`` sizes only the attention's
    buffers, which the ring holds at both head sizes."""
    stage = 2 * _BOX_ROWS * _BK * 2 + _TERMS * nb * _BK * 2
    idx = (3 * MAX_BATCH + 2 + 2 * _SUB) * 4 // 8 * 8
    return (1024 + _stages(nb) * stage + 8 * MAX_BATCH * 4 + MAX_BATCH * 4
            + 16 + idx + 2 * _stages(nb) * 8)


def _scratch_floats(b, h_kv, rep, d, hd, i_size, sms=_SMS):
    """The source's ``scratch_layout`` (``ptt_decode_layer_scratch``) for
    a grid of ``sms`` blocks: the attention pieces, the
    activation terms of o, h1 * w_post and z (bf16), h1, the sums of
    squares, the partial tiles, h2, each rounded up to 64 floats."""
    t2, t3 = -(-hd // (2 * _BOX_ROWS)), -(-i_size // _BOX_ROWS)
    regions = ((sms + b * h_kv) * rep * (d + 2),
               _TERMS * b * h_kv * rep * d // 2, b * hd, _TERMS * b * hd // 2,
               t2 * b, (sms + max(t2, t3)) * _nb(b) * 2 * _BOX_ROWS,
               _TERMS * b * i_size // 2, b * hd, t2 * b)
    return sum(-(-n // 64) * 64 for n in regions)


def _ex(label, lengths, h, h_kv, d, hd, i_size, ps=16, max_pages=128,
        seed=7):
    """One cooperative launch of one block a multiprocessor, its phases
    split by the kernel's own barriers: the writes of y, h and the scratch
    depend on the phase schedule and the counters (writes=None; the guard
    plane checks them). A cudaMemsetAsync of the scratch's counters comes
    first on the stream."""
    from ._examples import fixed, model, normal
    from .mmha import paged_tables
    m = model()
    bf = torch.bfloat16
    b = len(lengths)
    tables, pos, n_pages = paged_tables(lengths, ps, max_pages, seed)
    shapes = {"q": (b, h, d), "k": (n_pages, h_kv, ps, d),
              "v": (n_pages, h_kv, ps, d), "hres": (b, hd),
              "wo": (hd, h * d), "wg": (i_size, hd), "wu": (i_size, hd),
              "wd": (hd, i_size)}
    ops = []
    for n in _NAMES:
        if n == "tables":
            ops.append(m.Operand(n, tuple(tables.shape), torch.int32,
                                 data=fixed(tables)))
        elif n == "pos":
            ops.append(m.Operand(n, (b,), torch.int32, data=fixed(pos)))
        elif n in ("w_post", "w_next"):
            ops.append(m.Operand(n, (hd,), bf, data=normal((hd,), bf, 0.1,
                                                           1.0)))
        elif n.startswith("w"):
            ops.append(m.Operand(n, shapes[n], bf, data=normal(shapes[n], bf,
                                                               0.02)))
        else:
            ops.append(m.Operand(n, shapes[n], bf))
    n_scratch = _scratch_floats(b, h_kv, h // h_kv, d, hd, i_size)
    ops += [m.Operand("y", (b, hd), bf, "out"),
            m.Operand("h", (b, hd), bf, "out"),
            m.Operand("scratch", (n_scratch,), torch.float32, "out"),
            # zero going in and coming out: an input the call leaves as it
            # found it
            m.Operand("ctrl", (ctrl_words(b, h_kv, hd, i_size),), torch.int32,
                      data=fixed(torch.zeros(ctrl_words(b, h_kv, hd, i_size),
                                             dtype=torch.int32)))]
    block_i = _pick_block_i(i_size)

    def plain(t):
        # the kernel keeps the attention output in f32: so does an f32 q
        args = [t[n] for n in _NAMES]
        args[0] = args[0].float()
        y, h_next = decode_layer_plain(*args, 1e-5, 1e-5)
        return {"y": y, "h": h_next}

    def launch(t, stream):
        _launch(tuple(t[n] for n in _NAMES), t["y"], t["h"], t["scratch"],
                t["ctrl"],
                1e-5, 1e-5, block_i, None, stream)

    kern = m.KernelLaunch(f"decode_layer_wgmma_kernel<{d},{_nb(b)}>",
                          _SMS, _THREADS, smem=_smem(d, _nb(b)),
                          writes=None, cooperative=True)
    seen = int((pos + 1).sum())
    nbytes = 2 * (hd * h * d + 3 * hd * i_size + 2 * hd
                  + 2 * seen * h_kv * d + b * h * d + 3 * b * hd)
    flops = 4 * seen * h * d + 2 * b * (h * d * hd + 3 * hd * i_size)
    return m.Example(label, "decode_layer", ops, [kern], launch, plain,
                     flops=flops, nbytes=nbytes, tol=2.0 ** -6)


def ck_examples():
    """At ``decode_layer_pallas.pk_examples``' shape (B 4, H 8 over Hkv 4,
    D 64, hidden 512, I 1024; the JAX example is f32, the kernel takes
    bf16) and phase 3's (Llama-3-8B's layer: B 8 over Hkv 8 at positions
    0..1500 with an inactive row 0, B 1, REP 1 over Hkv 32, and B 16, the
    wgmma's N 16); tails with positions that end inside a page, hidden and
    I past their last full tile, and a batch of 3 (12 for B 16's, so every
    instantiation has an example)."""
    from ._examples import with_tail
    tail = dict(lengths=[1, 37, 100], h=8, h_kv=4, d=64, hd=520,
                i_size=1040)
    out = [with_tail(_ex, "decode_layer",
                     dict(lengths=[64, 48, 30, 17], h=8, h_kv=4, d=64, hd=512,
                          i_size=1024, max_pages=4), tail)]
    # batch 12: the 16-row wgmma width at D 64
    wide_tail = dict(tail, lengths=[1 + 37 * r for r in range(12)])
    for label, lengths, h_kv in (
            ("phase3 B 8", [0, 18, 256, 257, 701, 1024, 1201, 1501], 8),
            ("phase3 B 1", [901], 8),
            ("phase3 rep 1", [0] + [100 + 190 * r for r in range(1, 8)], 32),
            ("phase3 B 16", [0, 18, 256, 257, 701, 1024, 1201, 1501] * 2, 8)):
        out.append(with_tail(_ex, label, dict(lengths=lengths, h=32,
                                              h_kv=h_kv, d=128, hd=4096,
                                              i_size=14336),
                             wide_tail if label == "phase3 B 16" else tail))
    return out

