"""Adam and AdamW (counterparts of ``paddle_tpu/optimizer/optimizers.py``
``Adam`` :79-155 and ``AdamW`` :157-184).

Every parameter goes through the fused AdamW kernel
(``ops/kernels/adamw.py``; a CPU tensor takes its plain version), except
with ``amsgrad=True``, which takes the JAX plain path (:135-150) in plain
PyTorch, as the TPU kernel does not cover it. The JAX package sends only
parameters of 8192 elements or more to its kernel (:100-106); the port
sends every one, which computes the same function. Adam couples a float
``weight_decay`` into the gradient before the update (L2); AdamW decays
the weights, decoupled, for every parameter that ``apply_decay_param_fun``
(called with the parameter's name) accepts. A parameter's
``optimize_attr["learning_rate"]`` scales the learning rate for it, as
``paddle_tpu/optimizer/optimizer.py:101-105`` reads it, and AdamW's
``lr_ratio(param)`` scales it once more (:174-176).
"""

from __future__ import annotations

import torch

from ..ops.kernels import adamw as _adamw
from .optimizer import Optimizer

__all__ = ["Adam", "AdamW"]


def _wd_coeff(weight_decay) -> float:
    return 0.0 if weight_decay is None else float(weight_decay)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, name=None, amsgrad=False,
                 fuse=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision, fuse=fuse)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._amsgrad = amsgrad
        self._decoupled = False
        self._scalars = None

    def _lr_mult(self, p) -> float:
        attr = getattr(p, "optimize_attr", None) or {}
        return float(attr.get("learning_rate", 1.0))

    def _decoupled_decay_for(self, p) -> float:
        return 0.0          # plain Adam couples decay into the gradient

    def _begin_step(self) -> None:
        self._scalars = _adamw.adamw_scalars(
            self._lr_tensor, self._step_tensor, self._beta1, self._beta2)

    def _append_optimize_op(self, p, grad) -> None:
        master = self._get_master(p)
        coeff = _wd_coeff(self._weight_decay)
        if not self._decoupled and coeff:
            grad = grad.float() + coeff * p.float()
        m = self._add_accumulator("moment1", p)
        v = self._add_accumulator("moment2", p)
        if not self._amsgrad:
            _adamw.adamw_update(p.data, grad, m, v, self._scalars,
                                beta1=self._beta1, beta2=self._beta2,
                                eps=self._epsilon,
                                wd=float(self._decoupled_decay_for(p)),
                                lr_mult=self._lr_mult(p), master=master)
            return
        g = grad.float()
        w32 = master if master is not None else p.float()
        t = self._step_tensor
        m.copy_(self._beta1 * m + (1 - self._beta1) * g)
        v.copy_(self._beta2 * v + (1 - self._beta2) * g.square())
        mhat = m / (1 - self._beta1 ** t)
        vmax = self._add_accumulator("moment2_max", p)
        torch.maximum(vmax, v / (1 - self._beta2 ** t), out=vmax)
        lr = self._lr_tensor * self._lr_mult(p)
        decay = self._decoupled_decay_for(p)
        if decay:
            w32 = w32 * (1.0 - lr * decay)
        new_w = w32 - lr * mhat / (torch.sqrt(vmax) + self._epsilon)
        if master is not None:
            master.copy_(new_w)
        p.data.copy_(new_w)


class AdamW(Adam):
    """Decoupled weight decay. ``apply_decay_param_fun(name)`` selects the
    parameters that decay; ``lr_ratio(param)`` scales the learning rate per
    parameter."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None,
                 amsgrad=False, fuse=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name=name, amsgrad=amsgrad, fuse=fuse)
        self._decoupled = True
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _lr_mult(self, p) -> float:
        mult = super()._lr_mult(p)
        return mult if self._lr_ratio is None else \
            mult * float(self._lr_ratio(p))

    def _decoupled_decay_for(self, p) -> float:
        if self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(self._names[id(p)]):
            return 0.0
        return _wd_coeff(self._weight_decay)
