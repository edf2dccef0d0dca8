"""Fused Adam / AdamW parameter update: CUDA kernel and plain version.

Replaces ``paddle_tpu/ops/kernels/adamw_pallas.py`` ``_adamw_call`` (:59;
kernel body ``_adamw_kernel`` :31-51), reached through ``adamw_update``
(:101-121). Source: ``paddle_tpu_torch/csrc/adamw.cu``.

One pass per parameter over ``(w32, g, m, v)``: the moments, the bias
correction, the decoupled decay ``w - (w * lr) * wd`` and the step
``w - (mhat / (sqrt(vhat) + eps)) * lr``, in the TPU kernel's order. Where
the JAX function returns new arrays, this one updates ``m``, ``v`` and the
weights in place (the f32 master and its parameter-dtype copy, or the
parameter itself), which keeps the optimizer state at one copy. The
scalars ``(lr, 1/bias_corr1, 1/bias_corr2)`` come as a small f32 tensor on
the parameter's device (:func:`adamw_scalars`, the TPU kernel's ``(1, 4)``
operand), so a learning-rate change and the step count never leave the
device and a step does not synchronise.

What bounds it on the H100: bytes, 28 an element with a master (w32, m, v
read and written, a bf16 gradient read, the bf16 copy written). The kernel
rounds every operation on its own, as the plain version's one tensor op per
operation does, so the two give the same bits on the card.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["adamw_update", "adamw_update_plain", "adamw_scalars",
           "check_operands", "kernel_form"]

_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong] + [ctypes.c_float] * 7 + [ctypes.c_void_p]
_MODE_F32, _MODE_MASTER, _MODE_BF16 = 0, 1, 2


def adamw_scalars(lr, step, beta1, beta2):
    """f32 ``[lr, 1/(1 - beta1**step), 1/(1 - beta2**step), 0]`` on the
    device of the 0-d f32 tensors ``lr`` and ``step``, computed there in
    f32 as ``adamw_update`` of the JAX package does (:109-114)."""
    # filled on the device: a tensor made from a Python number would be a
    # copy from the host, which synchronises
    b1 = torch.full((), beta1, dtype=torch.float32, device=step.device)
    b2 = torch.full((), beta2, dtype=torch.float32, device=step.device)
    return torch.stack([lr.float().reshape(()), 1.0 / (1.0 - b1 ** step),
                        1.0 / (1.0 - b2 ** step), torch.zeros_like(b1)])


def check_operands(what, param, grad, m, v, scalars, master):
    """Raise unless ``(param, grad, m, v, scalars, master)`` fit an
    optimizer update: one shape, f32 moments, float parameter and
    gradient, an f32 master of the parameter's shape, f32 scalars, one
    device. Shared by the AdamW and LAMB wrappers."""
    if param.shape != grad.shape or m.shape != param.shape \
            or v.shape != param.shape:
        raise ValueError(f"{what}: param {tuple(param.shape)}, grad "
                         f"{tuple(grad.shape)}, m {tuple(m.shape)} and v "
                         f"{tuple(v.shape)} must match")
    if m.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"{what}: moments must be f32, got {m.dtype} / "
                        f"{v.dtype}")
    if not (param.is_floating_point() and grad.is_floating_point()):
        raise TypeError(f"{what}: param {param.dtype} and grad {grad.dtype} "
                        f"must be floating")
    if master is not None and (master.dtype != torch.float32
                               or master.shape != param.shape):
        raise ValueError(f"{what}: master must be f32 {tuple(param.shape)}, "
                         f"got {master.dtype} {tuple(master.shape)}")
    if scalars.dtype != torch.float32 or scalars.numel() < 3:
        raise ValueError(f"{what}: scalars must be f32 [lr, 1/bc1, 1/bc2, "
                         f"...]")
    if any(t is not None and t.device != param.device
           for t in (grad, m, v, scalars, master)):
        raise ValueError(f"{what}: operands on different devices")


def kernel_form(what, param, grad, m, v, scalars, master):
    """``(mode, w32, low)`` of a launch on the card: an f32 parameter
    updated in place (mode 0), an f32 master with its bf16 copy (1), or a
    bf16 parameter (2), as ``csrc/adamw.cu`` and ``csrc/lamb.cu`` take
    them. Raises on what those kernels do not take."""
    if param.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {param.device}")
    if master is not None:
        if param.dtype != torch.bfloat16:
            raise TypeError(f"{what} kernel writes a bf16 copy of the master, "
                            f"got param {param.dtype}")
        form = (_MODE_MASTER, master, param)
    elif param.dtype == torch.float32:
        form = (_MODE_F32, param, None)
    elif param.dtype == torch.bfloat16:
        form = (_MODE_BF16, None, param)
    else:
        raise TypeError(f"{what} kernel takes f32 or bf16 params, got "
                        f"{param.dtype}")
    if grad.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what} kernel takes bf16 or f32 grads, got "
                        f"{grad.dtype}")
    ops = [t for t in (param, grad, m, v, scalars, master) if t is not None]
    if not all(t.is_contiguous() for t in ops):
        raise ValueError(f"{what} kernel takes contiguous tensors")
    _build.require_aligned(what, *ops)
    return form


def adamw_update_plain(param, grad, m, v, scalars, *, beta1, beta2, eps, wd,
                       lr_mult=1.0, master=None):
    """The same update in plain PyTorch, one tensor op per operation, in
    place on ``m``, ``v`` and ``master`` (if given, with ``param`` written
    from it) or ``param``."""
    check_operands("adamw", param, grad, m, v, scalars, master)
    w = master if master is not None else param.float()
    lr = scalars[0] * lr_mult if lr_mult != 1.0 else scalars[0]
    g = grad.float()
    m.copy_(m * beta1 + g * (1 - beta1))
    v.copy_(v * beta2 + (g * g) * (1 - beta2))
    mhat = m * scalars[1]
    vhat = v * scalars[2]
    w_new = w - (w * lr) * wd
    w_new = w_new - (mhat / (torch.sqrt(vhat) + eps)) * lr
    if master is not None:
        master.copy_(w_new)
    param.copy_(w_new)


def adamw_update(param, grad, m, v, scalars, *, beta1, beta2, eps, wd,
                 lr_mult=1.0, master=None):
    """One decoupled-decay Adam step in place. ``master`` is the f32 copy
    of a low-precision ``param`` (which is then written from it); without
    one, ``param`` itself is updated (f32 math). ``scalars`` is
    :func:`adamw_scalars`' tensor; ``lr_mult`` scales its lr for this
    parameter. A CPU tensor takes :func:`adamw_update_plain`; a CUDA tensor
    launches the kernel (param f32 or bf16, grad bf16 or f32, contiguous)
    or raises."""
    check_operands("adamw", param, grad, m, v, scalars, master)
    if param.device.type == "cpu":
        return adamw_update_plain(param, grad, m, v, scalars, beta1=beta1,
                                  beta2=beta2, eps=eps, wd=wd,
                                  lr_mult=lr_mult, master=master)
    _launch(kernel_form("adamw", param, grad, m, v, scalars, master), grad,
            m, v, scalars, beta1, beta2, eps, wd, lr_mult,
            _build.stream_of(param))
    adamw_update.launches += 1


adamw_update.launches = 0


def _launch(form, grad, m, v, scalars, beta1, beta2, eps, wd, lr_mult,
            stream):
    """The C entry on ``kernel_form``'s ``(mode, w32, low)``."""
    mode, w32, low = form
    fn = _build.function("adamw", "ptt_adamw", _ARGS)
    err = fn(mode, None if w32 is None else w32.data_ptr(),
             None if low is None else low.data_ptr(), grad.data_ptr(),
             int(grad.dtype == torch.bfloat16), m.data_ptr(), v.data_ptr(),
             scalars.data_ptr(), m.numel(), float(beta1), float(1 - beta1),
             float(beta2), float(1 - beta2), float(eps), float(wd),
             float(lr_mult), stream)
    _build.check(err, "adamw")


# -- declared launches for the kernel analyzer -------------------------------

#: hyper-parameters of the examples (phase 3's)
EXAMPLE_HYPER = dict(beta1=0.9, beta2=0.999, eps=1e-8, wd=0.01)


def example_state(m, shape, grad_dtype, lr, m_data, v_scale):
    """Operands of an optimizer example with an f32 master and its bf16
    copy (``prepare`` writes the copy): master ``0.02 N``, grad ``1e-3 N``
    in ``grad_dtype``, warm moments (``m_data`` makes m, v is uniform in
    ``[0, v_scale)``), the step-3 scalars of ``lr``."""
    from ._examples import fixed, normal, uniform
    f32 = torch.float32
    scal = adamw_scalars(torch.tensor(lr), torch.tensor(3.0), 0.9, 0.999)
    ops = [m.Operand("w32", shape, f32, "inout", data=normal(shape, f32,
                                                             0.02)),
           m.Operand("p", shape, torch.bfloat16, "inout"),
           m.Operand("g", shape, grad_dtype, data=normal(shape, grad_dtype,
                                                         1e-3)),
           m.Operand("m", shape, f32, "inout", data=m_data),
           m.Operand("v", shape, f32, "inout", data=uniform(shape, f32, 0,
                                                            v_scale)),
           m.Operand("scal", (4,), f32, data=fixed(scal))]

    def prepare(t):
        t["p"] = t["w32"].to(torch.bfloat16)
    return ops, prepare


def _ex(label, shape, grad_dtype):
    """A grid-stride loop of 4 elements a thread over at most 8 blocks an
    SM: block b updates chunks b, b + grid, ... of 1024 elements in place."""
    from ._examples import model
    mm = model()
    n = shape[0] * shape[1]
    grid = max(1, min(132 * 8, -(-(n // 4) // 256)))
    from ._examples import uniform
    ops, prepare = example_state(mm, shape, grad_dtype, 1e-4,
                                 uniform(shape, torch.float32, 0, 1e-3), 1e-6)
    maps = [mm.stride_map(k, n, 1024, grid) for k in ("w32", "p", "m", "v")]

    def plain(t):
        adamw_update_plain(t["p"], t["g"], t["m"], t["v"], t["scal"],
                           master=t["w32"], **EXAMPLE_HYPER)
        return {k: t[k] for k in ("w32", "p", "m", "v")}

    def launch(t, stream):
        _launch((_MODE_MASTER, t["w32"], t["p"]), t["g"], t["m"], t["v"],
                t["scal"], stream=stream, lr_mult=1.0, **EXAMPLE_HYPER)

    gt = "__nv_bfloat16" if grad_dtype == torch.bfloat16 else "float"
    kern = mm.KernelLaunch(f"adamw_kernel<{gt},{_MODE_MASTER}>", grid, 256,
                           writes=maps)
    return mm.Example(label, "adamw", ops, [kern], launch, plain,
                      flops=15 * n, nbytes=(28 if grad_dtype == torch.bfloat16
                                            else 30) * n,
                      tol=0.0, prepare=prepare)


def ck_examples():
    """At ``adamw_pallas.pk_examples``' shape ([4096, 1024], f32 master and
    gradient, bf16 out) and phase 3's ([14336, 4096], f32 master, bf16
    gradient): bit for bit the plain version; tails with an element count
    that is not a multiple of 4."""
    from ._examples import with_tail
    return [with_tail(_ex, label, dict(shape=shape, grad_dtype=gd),
                      dict(shape=(37, 1001), grad_dtype=gd))
            for label, shape, gd in (
                ("adamw_update", (4096, 1024), torch.float32),
                ("phase3 [14336, 4096]", (14336, 4096), torch.bfloat16))]
