"""The optimizers (counterparts of ``paddle_tpu/optimizer/optimizers.py``:
``SGD`` :27, ``Momentum`` :48, ``Adam`` :79-155, ``AdamW`` :157-184,
``Adagrad`` :186, ``Adadelta`` :208, ``Adamax`` :231, ``RMSProp`` :254,
``Lamb`` :282-347 and ``LBFGS`` :350-422).

Adam and AdamW send every parameter through the fused AdamW kernel
(``ops/kernels/adamw.py``), except with ``amsgrad=True``, which takes the
JAX plain path (:135-150), as the TPU kernel does not cover it. Lamb sends
every parameter through the LAMB kernel (``ops/kernels/lamb.py``). The JAX
package sends only parameters of 8192 elements or more to those kernels
(:100-106, :294-298); the port sends every one, which computes the same
function. A CPU tensor takes each kernel's plain version.

SGD, Momentum, Adagrad, Adadelta, Adamax and RMSProp are plain tensor
arithmetic, as the JAX package computes them outside any Pallas kernel,
with its accumulator names (they key ``state_dict``) and its order of
operations; on the card they run as PyTorch ops on device tensors, and
``step()`` does not synchronise. SGD, Momentum, Adam, AdamW and Lamb keep
f32 master weights with ``multi_precision``; the others compute in f32
and round to the parameter's dtype, as JAX does. LBFGS reads the loss and
the gradient's largest entry on the host where JAX does.

Coupled decay (a float ``weight_decay``, or an ``L1Decay``/``L2Decay``)
is added to the gradient before the update; AdamW decays the weights,
decoupled, for every parameter that ``apply_decay_param_fun`` (called
with the parameter's name) accepts, and Lamb by ``lamb_weight_decay``
except where ``exclude_from_weight_decay_fn(param)`` is true. A
parameter's ``optimize_attr["learning_rate"]`` scales the learning rate
for it, and AdamW's ``lr_ratio(param)`` scales it once more (:174-176).
Each optimizer but LBFGS declares the accumulators it makes
(``_fused_state_names``, JAX's names) and takes ``fuse=True`` (one CUDA
graph a step, ``optimizer/fused.py``); LBFGS steps through its closure
and takes no ``fuse``, as in JAX.
"""

from __future__ import annotations

import torch

from ..ops.kernels import adamw as _adamw
from ..ops.kernels import lamb as _lamb
from .optimizer import Optimizer

__all__ = ["SGD", "Momentum", "Adam", "AdamW", "Adagrad", "Adadelta",
           "Adamax", "RMSProp", "Lamb", "LBFGS"]


def _wd_coeff(weight_decay) -> float:
    return 0.0 if weight_decay is None else float(weight_decay)


def _write(p, master, new_w) -> None:
    """``new_w`` (f32) into the master copy, if any, and the parameter."""
    if master is not None:
        master.copy_(new_w)
    p.copy_(new_w)


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None, fuse=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision, fuse=fuse)

    _keeps_master = True

    def _fused_state_names(self, p):
        return []

    def _append_optimize_op(self, p, grad) -> None:
        g = self._apply_coupled_weight_decay(p, grad.float())
        master = self._get_master(p)
        w = master if master is not None else p
        _write(p, master, w.float() - self._lr(p) * g.to(w.dtype).float())


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None, fuse=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision, fuse=fuse)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    _keeps_master = True

    def _fused_state_names(self, p):
        return ["velocity"]

    def _append_optimize_op(self, p, grad) -> None:
        g = self._apply_coupled_weight_decay(p, grad.float())
        master = self._get_master(p)
        w = master if master is not None else p
        vel = self._add_accumulator("velocity", p)
        v_new = self._momentum * vel + g
        upd = g + self._momentum * v_new if self._use_nesterov else v_new
        vel.copy_(v_new)
        _write(p, master, w.float() - self._lr(p) * upd.to(w.dtype).float())


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

    _keeps_master = True

    def _fused_state_names(self, p):
        return ["moment1", "moment2", "moment2_max"] if self._amsgrad \
            else ["moment1", "moment2"]

    def _decoupled_decay_for(self, p) -> float:
        return 0.0          # plain Adam couples decay into the gradient

    def _begin_step(self) -> None:
        self._scalars = _adamw.adamw_scalars(
            self._lr_tensor, self._step_tensor, self._beta1, self._beta2)

    def _append_optimize_op(self, p, grad) -> None:
        master = self._get_master(p)
        if not self._decoupled and self._regularization is not None:
            grad = self._apply_coupled_weight_decay(p, grad.float())
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
        lr = self._lr(p)
        decay = self._decoupled_decay_for(p)
        if decay:
            w32 = w32 * (1.0 - lr * decay)
        _write(p, master,
               w32 - lr * mhat / (torch.sqrt(vmax) + self._epsilon))


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
        self._regularization = None      # decay is decoupled, never coupled
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


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, multi_precision=False,
                 name=None, fuse=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision, fuse=fuse)
        self._epsilon = epsilon
        self._initial = initial_accumulator_value

    def _fused_state_names(self, p):
        return ["moment"]

    def _append_optimize_op(self, p, grad) -> None:
        g = self._apply_coupled_weight_decay(p, grad.float())
        acc = self._add_accumulator("moment", p, fill_value=self._initial)
        acc.copy_(acc + g.square())
        p.copy_(p.float() - self._lr(p) * g
                / (torch.sqrt(acc) + self._epsilon))


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None, fuse=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision, fuse=fuse)
        self._epsilon, self._rho = epsilon, rho

    def _fused_state_names(self, p):
        return ["avg_squared_grad", "avg_squared_update"]

    def _append_optimize_op(self, p, grad) -> None:
        g = self._apply_coupled_weight_decay(p, grad.float())
        avg_sq = self._add_accumulator("avg_squared_grad", p)
        avg_up = self._add_accumulator("avg_squared_update", p)
        avg_sq.copy_(self._rho * avg_sq + (1 - self._rho) * g.square())
        upd = torch.sqrt(avg_up + self._epsilon) \
            / torch.sqrt(avg_sq + self._epsilon) * g
        avg_up.copy_(self._rho * avg_up + (1 - self._rho) * upd.square())
        p.copy_(p.float() - self._lr(p) * upd)


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None,
                 fuse=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision, fuse=fuse)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _fused_state_names(self, p):
        return ["moment", "inf_norm"]

    def _append_optimize_op(self, p, grad) -> None:
        g = self._apply_coupled_weight_decay(p, grad.float())
        m = self._add_accumulator("moment", p)
        u = self._add_accumulator("inf_norm", p)
        m.copy_(self._beta1 * m + (1 - self._beta1) * g)
        torch.maximum(self._beta2 * u, g.abs(), out=u)
        lr = self._lr(p) / (1 - self._beta1 ** self._step_tensor)
        p.copy_(p.float() - lr * m / (u + self._epsilon))


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None,
                 fuse=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision, fuse=fuse)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _fused_state_names(self, p):
        names = ["mean_square", "momentum"]
        return names + ["mean_grad"] if self._centered else names

    def _append_optimize_op(self, p, grad) -> None:
        g = self._apply_coupled_weight_decay(p, grad.float())
        ms = self._add_accumulator("mean_square", p)
        mom = self._add_accumulator("momentum", p)
        ms.copy_(self._rho * ms + (1 - self._rho) * g.square())
        if self._centered:
            mg = self._add_accumulator("mean_grad", p)
            mg.copy_(self._rho * mg + (1 - self._rho) * g)
            denom = torch.sqrt(ms - mg.square() + self._epsilon)
        else:
            denom = torch.sqrt(ms + self._epsilon)
        mom.copy_(self._momentum * mom + self._lr(p) * g / denom)
        p.copy_(p.float() - mom)


class Lamb(Optimizer):
    """Layer-wise adaptive moments: each parameter's Adam direction plus
    ``lamb_weight_decay * w``, scaled by its trust ratio ``|w| / |r|``,
    through the LAMB kernel."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None, fuse=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision, fuse=fuse)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn
        self._scalars = None

    _keeps_master = True

    def _fused_state_names(self, p):
        return ["moment1", "moment2"]

    def _begin_step(self) -> None:
        self._scalars = _adamw.adamw_scalars(
            self._lr_tensor, self._step_tensor, self._beta1, self._beta2)

    def _append_optimize_op(self, p, grad) -> None:
        m = self._add_accumulator("moment1", p)
        v = self._add_accumulator("moment2", p)
        wd = self._lamb_wd
        if self._exclude_fn is not None and self._exclude_fn(p):
            wd = 0.0
        _lamb.lamb_update(p.data, grad, m, v, self._scalars,
                          beta1=self._beta1, beta2=self._beta2,
                          eps=self._epsilon, wd=float(wd),
                          lr_mult=self._lr_mult(p),
                          master=self._get_master(p))


class LBFGS(Optimizer):
    """L-BFGS over all parameters as one flat vector, with a closure that
    clears the gradients, computes the loss, calls ``backward()`` and
    returns the loss. Each iteration takes a step of the learning rate's
    length along the two-loop direction (no line search, as in JAX) and
    keeps the curvature pair when ``s . y > 1e-10``."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._max_iter = max_iter
        self._tol_grad = tolerance_grad
        self._tol_change = tolerance_change
        self._history_size = history_size
        self._line_search_fn = line_search_fn
        self._s, self._y = [], []

    def _gather_flat_grad(self):
        return torch.cat([
            (p.grad if p.grad is not None else torch.zeros_like(p))
            .float().reshape(-1) for p in self._parameter_list])

    @torch.no_grad()
    def _add_to_params(self, step, direction) -> None:
        offset = 0
        for p in self._parameter_list:
            n = p.numel()
            upd = direction[offset:offset + n].reshape(p.shape)
            p.copy_(p.float() + step * upd)
            offset += n

    def step(self, closure=None):
        if closure is None:
            raise ValueError("LBFGS.step requires a closure")
        loss = closure()
        flat_grad = self._gather_flat_grad()
        for _ in range(self._max_iter):
            if float(flat_grad.abs().max()) <= self._tol_grad:
                break
            # two-loop recursion
            q = flat_grad
            alphas = []
            for s, y in zip(reversed(self._s), reversed(self._y)):
                rho = 1.0 / torch.dot(y, s).clamp_min(1e-10)
                a = rho * torch.dot(s, q)
                q = q - a * y
                alphas.append((a, rho, s, y))
            if self._y:
                gamma = torch.dot(self._s[-1], self._y[-1]) / torch.dot(
                    self._y[-1], self._y[-1]).clamp_min(1e-10)
                q = gamma * q
            for a, rho, s, y in reversed(alphas):
                b = rho * torch.dot(y, q)
                q = q + (a - b) * s
            direction = -q
            step = float(self._lr())
            self._add_to_params(step, direction)
            self.clear_grad()
            new_loss = closure()
            new_flat = self._gather_flat_grad()
            s_vec = step * direction
            y_vec = new_flat - flat_grad
            if float(torch.dot(s_vec, y_vec)) > 1e-10:
                self._s.append(s_vec)
                self._y.append(y_vec)
                if len(self._s) > self._history_size:
                    self._s.pop(0)
                    self._y.pop(0)
            if abs(float(new_loss.detach()) - float(loss.detach())) \
                    < self._tol_change:
                loss = new_loss
                break
            loss, flat_grad = new_loss, new_flat
        return loss
