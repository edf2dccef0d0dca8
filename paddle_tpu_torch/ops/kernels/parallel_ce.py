"""Softmax cross entropy from per-row statistics: CUDA kernel, plain
version and the differentiable loss around them.

Replaces ``paddle_tpu/ops/kernels/ce_pallas.py`` ``_row_stats`` (:66;
kernel body ``_stats_kernel`` :43). Source:
``paddle_tpu_torch/csrc/cross_entropy.cu``. One pass over each row of
``[N, V]`` logits (bf16 or f32, read as f32) gives three f32 ``[N]``
tensors: the row max, ``sum(exp(logit - max))`` and the target logit, or
-1e30 where the label lies outside ``[vocab_start, vocab_start + V)``
(the TPU kernel's stand-in for -inf).

:func:`c_softmax_with_cross_entropy` computes what the JAX function of
that name computes around its kernel (:116-152), in plain PyTorch: the
loss ``log(se) + mx - tg``, rows whose label is ``ignore_index`` taking
label 0 for the kernel and loss 0, and the backward ``(softmax - onehot)
* dloss`` cast to the logits' dtype (an XLA pass in JAX, :139-150; no
kernel there either). The single-device path only: the vocab-sharded
combine of the statistics across devices is not ported.

What bounds the kernel on the H100: bytes, one read of the logits. Its
sum of exponentials is taken in another order than ``torch.sum``, with
the fast exponential, so ``se`` agrees with the plain version to f32
rounding; ``mx`` and ``tg`` are exact.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["row_stats", "row_stats_plain", "c_softmax_with_cross_entropy",
           "CrossEntropyFunction"]

_NEG = -1e30
_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


def _check(logits2, labels):
    if logits2.dim() != 2 or labels.shape != logits2.shape[:1]:
        raise ValueError(f"row_stats: logits [N, V] and labels [N], got "
                         f"{tuple(logits2.shape)} and {tuple(labels.shape)}")
    if not logits2.is_floating_point():
        raise TypeError(f"row_stats: logits must be floating, got "
                        f"{logits2.dtype}")
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"row_stats: labels must be int32 or int64, got "
                        f"{labels.dtype}")
    if labels.device != logits2.device:
        raise ValueError("row_stats: logits and labels on different devices")


def row_stats_plain(logits2, labels, vocab_start=0):
    """``(mx, se, tg)`` of logits ``[N, V]`` (any float type, any V) and
    global labels ``[N]``, in plain PyTorch with f32 math."""
    _check(logits2, labels)
    lg = logits2.float()
    v = lg.shape[-1]
    mx = lg.max(dim=-1).values
    se = torch.exp(lg - mx[:, None]).sum(dim=-1)
    local = labels.long() - vocab_start
    hit = (local >= 0) & (local < v)
    tg = lg.gather(1, local.clamp(0, v - 1)[:, None]).squeeze(1)
    return mx, se, torch.where(hit, tg, torch.full_like(tg, _NEG))


def row_stats(logits2, labels, vocab_start=0):
    """The same three statistics. A CPU tensor takes
    :func:`row_stats_plain`; a CUDA tensor launches the kernel (logits
    bf16 or f32, contiguous, at most 2**31 - 1 rows) or raises."""
    _check(logits2, labels)
    if logits2.device.type == "cpu":
        return row_stats_plain(logits2, labels, vocab_start)
    if logits2.device.type != "cuda":
        raise ValueError(f"row_stats: no kernel for device {logits2.device}")
    if logits2.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"row_stats kernel takes bf16 or f32 logits, got "
                        f"{logits2.dtype}")
    n, v = logits2.shape
    if n == 0 or v == 0 or n >= 2 ** 31 or v >= 2 ** 31:
        raise ValueError(f"row_stats kernel takes 1 to 2**31 - 1 rows and "
                         f"columns, got {tuple(logits2.shape)}")
    if not logits2.is_contiguous():
        raise ValueError("row_stats kernel takes contiguous logits")
    _build.require_aligned("row_stats", logits2)
    labels = labels.to(torch.int64).contiguous()
    mx, se, tg = (torch.empty(n, dtype=torch.float32, device=logits2.device)
                  for _ in range(3))
    _launch(logits2, labels, vocab_start, mx, se, tg,
            _build.stream_of(logits2))
    row_stats.launches += 1
    return mx, se, tg


row_stats.launches = 0


def _vectorized(logits2) -> bool:
    """Every row a whole number of 16-byte vectors."""
    return logits2.shape[1] * logits2.element_size() % 16 == 0


def _launch(logits2, labels, vocab_start, mx, se, tg, stream):
    """The C entry on operands the caller allocated (int64 labels)."""
    n, v = logits2.shape
    fn = _build.function("cross_entropy", "ptt_ce_row_stats", _ARGS)
    err = fn(logits2.data_ptr(), int(logits2.dtype == torch.bfloat16),
             labels.data_ptr(), n, v, int(vocab_start), mx.data_ptr(),
             se.data_ptr(), tg.data_ptr(), int(_vectorized(logits2)), stream)
    _build.check(err, "row_stats")


class CrossEntropyFunction(torch.autograd.Function):
    """Per-row loss of logits ``[.., V]`` and global labels ``[..]``; the
    forward launches the row-statistics kernel (``plain=True``: its plain
    version), the backward is plain tensor code."""

    @staticmethod
    def forward(ctx, logits, labels, vocab_start, ignore_index, plain):
        shp = logits.shape
        l2 = logits.reshape(-1, shp[-1])
        lab = labels.reshape(-1).long()
        valid = None
        if ignore_index is not None:
            valid = lab != ignore_index
            lab = torch.where(valid, lab, torch.zeros_like(lab))
        stats = row_stats_plain if plain else row_stats
        mx, se, tg = stats(l2, lab, vocab_start)
        loss = torch.log(se) + mx - tg
        if valid is not None:
            loss = torch.where(valid, loss, torch.zeros_like(loss))
        ctx.save_for_backward(l2, lab, mx, se,
                              *(() if valid is None else (valid,)))
        ctx.vocab_start, ctx.shape = vocab_start, shp
        return loss.reshape(shp[:-1])

    @staticmethod
    def backward(ctx, g):
        l2, lab, mx, se, *valid = ctx.saved_tensors
        v = l2.shape[-1]
        soft = torch.exp(l2.float() - mx[:, None])
        soft.div_(se[:, None])
        local = lab - ctx.vocab_start
        hit = (local >= 0) & (local < v)
        # soft - onehot: 1 off each row's target, 0 (exactly) elsewhere
        soft.scatter_add_(1, local.clamp(0, v - 1)[:, None],
                          -hit.to(soft.dtype)[:, None])
        soft.mul_(g.reshape(-1, 1).float())
        if valid:
            soft.masked_fill_(~valid[0][:, None], 0.0)
        return soft.reshape(ctx.shape).to(l2.dtype), None, None, None, None


def c_softmax_with_cross_entropy(logits, label, vocab_start=0,
                                 ignore_index=None, plain=False):
    """Per-row softmax cross entropy ``[..]`` (f32) of logits ``[.., V]``
    and int labels ``[..]`` (global ids; ``vocab_start`` is the first id
    these logits hold, 0 on one device). Rows whose label equals
    ``ignore_index`` give loss 0 and zero gradients. Differentiable in
    ``logits``."""
    return CrossEntropyFunction.apply(logits, label, int(vocab_start),
                                      ignore_index, plain)


# -- declared launches for the kernel analyzer -------------------------------

def _ex(label, n, v, dtype):
    """A block a row: its max, sum of exponentials and target logit."""
    from ._examples import CTYPE, model, normal
    m = model()
    ops = [m.Operand("logits", (n, v), dtype, data=normal((n, v), dtype, 2.0)),
           m.Operand("labels", (n,), torch.int64,
                     data=lambda gen, dev: torch.randint(
                         0, v, (n,), generator=gen, device=dev)),
           m.Operand("mx", (n,), torch.float32, "out"),
           m.Operand("se", (n,), torch.float32, "out"),
           m.Operand("tg", (n,), torch.float32, "out")]
    per_row = [m.TileMap(k, (1,), lambda x, y, z: (x,))
               for k in ("mx", "se", "tg")]
    vec = str(v * dtype.itemsize % 16 == 0).lower()

    def plain(t):
        mx, se, tg = row_stats_plain(t["logits"], t["labels"])
        return {"mx": mx, "se": se, "tg": tg}

    def launch(t, stream):
        _launch(t["logits"], t["labels"], 0, t["mx"], t["se"], t["tg"],
                stream)

    kern = m.KernelLaunch(f"ce_row_stats_kernel<{CTYPE[dtype]},{vec}>", n,
                          256, writes=per_row,
                          reads=[m.rows_map("logits", n, v)])
    return m.Example(label, "cross_entropy", ops, [kern], launch, plain,
                     flops=4 * n * v,
                     nbytes=dtype.itemsize * n * v + 8 * n + 12 * n,
                     tol={"se": 1e-5, "*": 0.0})


def ck_examples():
    """At ``ce_pallas.pk_examples``' shape (f32 logits [512, 4096]; the
    port's labels are int64) and phase 3's (bf16 [4096, 128256] and [8192,
    50304]); tails with a vocabulary that is not a whole number of 16-byte
    vectors (the unvectorized kernel)."""
    from ._examples import with_tail
    return [with_tail(_ex, label, dict(n=n, v=v, dtype=dt),
                      dict(n=37, v=1001, dtype=dt))
            for label, n, v, dt in (
                ("row_stats", 512, 4096, torch.float32),
                ("phase3 [4096, 128256]", 4096, 128256, torch.bfloat16),
                ("phase3 [8192, 50304]", 8192, 50304, torch.bfloat16))]
