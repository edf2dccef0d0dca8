"""LAMB parameter update: CUDA kernel and plain version.

Replaces ``paddle_tpu/ops/kernels/lamb_pallas.py`` ``_lamb_call`` (:78;
kernel bodies ``_moments_kernel`` :37 and ``_apply_kernel`` :53), reached
through ``lamb_update`` (:145-168). Source: ``paddle_tpu_torch/csrc/lamb.cu``.

Two passes per parameter. Pass A updates the moments and sums ``w**2``
and ``r**2`` per block, with ``r = (m * ibc1) / (sqrt(v * ibc2) + eps) +
wd * w`` (the inverse bias corrections multiplied in, as the TPU kernel
does, :43-47). Pass B forms ``trust = |w| / |r|`` (1 where either norm is
0) and ``lr * trust`` on the device from those partials, recomputes ``r``
and writes ``w - lr * trust * r``. Where the JAX function returns new
arrays, this one updates ``m``, ``v`` and the weights in place (the f32
master and its parameter-dtype copy, or the parameter itself) and returns
``trust`` as a 0-d f32 tensor. The scalars ``(lr, 1/bias_corr1,
1/bias_corr2)`` come from :func:`~.adamw.adamw_scalars`, so a scheduler's
new rate and the step count never leave the device and a step does not
synchronise.

What bounds it on the H100: bytes, 40 an element with a master (pass A
reads w32, m, v and a bf16 g and writes m, v; pass B reads w32, m, v and
writes w32 and the bf16 copy). The kernel rounds every elementwise
operation on its own, in the plain version's order, so the moments agree
bit for bit; the norms are summed in another order, so ``trust`` and the
weights agree to f32 rounding.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .adamw import check_operands, kernel_form

__all__ = ["lamb_update", "lamb_update_plain"]

_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong] + [ctypes.c_float] * 7 + [ctypes.c_void_p] * 3


def lamb_update_plain(param, grad, m, v, scalars, *, beta1, beta2, eps, wd,
                      lr_mult=1.0, master=None):
    """The same update in plain PyTorch, one tensor op per operation of
    the kernel, in place on ``m``, ``v`` and ``master`` (if given, with
    ``param`` written from it) or ``param``. Returns ``trust``."""
    check_operands("lamb", param, grad, m, v, scalars, master)
    w = master if master is not None else param.float()
    lr = scalars[0] * lr_mult if lr_mult != 1.0 else scalars[0]
    g = grad.float()
    m.copy_(m * beta1 + g * (1 - beta1))
    v.copy_(v * beta2 + (g * g) * (1 - beta2))
    r = (m * scalars[1]) / (torch.sqrt(v * scalars[2]) + eps) + w * wd
    w_norm = torch.sqrt((w * w).sum())
    r_norm = torch.sqrt((r * r).sum())
    trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                        torch.ones_like(w_norm))
    w_new = w - (lr * trust) * r
    if master is not None:
        master.copy_(w_new)
    param.copy_(w_new)
    return trust


def lamb_update(param, grad, m, v, scalars, *, beta1, beta2, eps, wd,
                lr_mult=1.0, master=None):
    """One LAMB step in place; returns the trust ratio (0-d f32). ``master``
    is the f32 copy of a low-precision ``param`` (which is then written
    from it); without one, ``param`` itself is updated (f32 math).
    ``scalars`` is :func:`~.adamw.adamw_scalars`' tensor; ``lr_mult``
    scales its lr for this parameter. A CPU tensor takes
    :func:`lamb_update_plain`; a CUDA tensor launches the kernel (param f32
    or bf16, grad bf16 or f32, contiguous, not empty) or raises."""
    check_operands("lamb", param, grad, m, v, scalars, master)
    if param.device.type == "cpu":
        return lamb_update_plain(param, grad, m, v, scalars, beta1=beta1,
                                 beta2=beta2, eps=eps, wd=wd,
                                 lr_mult=lr_mult, master=master)
    mode, w32, low = kernel_form("lamb", param, grad, m, v, scalars, master)
    if param.numel() == 0:
        raise ValueError("lamb kernel takes a non-empty parameter")
    fn = _build.function("lamb", "ptt_lamb", _ARGS)
    max_blocks = _build.function("lamb", "ptt_lamb_max_blocks", [])()
    part = torch.empty(2 * max_blocks, dtype=torch.float32,
                       device=param.device)
    trust = torch.empty((), dtype=torch.float32, device=param.device)
    err = fn(mode, None if w32 is None else w32.data_ptr(),
             None if low is None else low.data_ptr(), grad.data_ptr(),
             int(grad.dtype == torch.bfloat16), m.data_ptr(), v.data_ptr(),
             scalars.data_ptr(), param.numel(), float(beta1),
             float(1 - beta1), float(beta2), float(1 - beta2), float(eps),
             float(wd), float(lr_mult), part.data_ptr(), trust.data_ptr(),
             _build.stream_of(param))
    _build.check(err, "lamb")
    lamb_update.launches += 1
    return trust


lamb_update.launches = 0
