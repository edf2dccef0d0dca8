"""Optimizer base class (counterpart of
``paddle_tpu/optimizer/optimizer.py`` ``Optimizer`` :25-240).

An optimizer holds a parameter list, reads ``param.grad`` filled by
``loss.backward()``, applies the gradient clip and updates the parameters
in place. The learning rate and the step count live in 0-d f32 tensors on
the parameters' device, so ``set_lr``, a scheduler's step and the bias
correction never leave the device and :meth:`Optimizer.step` does not
synchronise. With ``multi_precision=True`` every parameter that is not
f32 gets an f32 master copy, which the update reads and writes; the
parameter is written from it.

Ported: ``parameters=`` (a list, or groups ``[{"params": [...]}, ...]``,
flattened as the JAX package does), a float learning rate with
``get_lr``/``set_lr`` or an :class:`~.lr.LRScheduler`, which binds to the
optimizer (:47-58) and makes ``set_lr`` raise (:91-94); ``weight_decay``
as a float (coupled L2) or an ``L1Decay``/``L2Decay`` object, applied to
the gradient by :meth:`Optimizer._apply_coupled_weight_decay` (:63-75,
:222-225); the device step counter, master weights, ``grad_clip``,
``step``, ``clear_grad(set_to_zero)`` and ``state_dict``/
``set_state_dict`` under the JAX key names (``<name>_moment1``,
``master_weights``, ``LR_Scheduler``, ``@step``), which also take a JAX
optimizer's ``state_dict()`` as numpy arrays. A parameter's name keys
that state: the name given with it (``parameters`` may hold ``(name,
param)`` pairs, as ``named_parameters()`` yields them; give the JAX
parameters' names to carry a JAX optimizer's state across), else its
``name`` attribute where it has one, else ``param_<i>`` by its place in
the list. ``fuse=True`` runs every step through
:class:`~.fused.FusedOptimizerStep` (on the card, one CUDA graph a step;
``fuse=None``, the default, and ``fuse=False`` step eagerly: the JAX
package's ``PADDLE_TPU_FUSED_OPT`` default is not taken). ``minimize(loss)``
is the dygraph branch (backward, step); the static-graph branch raises, as
``paddle.static`` is not ported.
"""

from __future__ import annotations

import numbers
import warnings

import torch

from ..regularizer import L2Decay
from .lr import LRScheduler

__all__ = ["Optimizer"]


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False, fuse=None):
        if parameters is None:
            raise ValueError("parameters must be provided")
        params = list(parameters)
        if params and isinstance(params[0], dict):
            params = [p for group in params for p in group["params"]]
        named = [item if isinstance(item, tuple)
                 else (getattr(item, "name", None), item) for item in params]
        params = [p for _, p in named]
        if not params:
            raise ValueError("the optimizer got an empty parameter list")
        self._lr_scheduler = None
        if isinstance(learning_rate, LRScheduler):
            self._lr_scheduler = learning_rate
            lr0 = float(learning_rate())
        else:
            lr0 = float(learning_rate)       # TypeError, as in JAX
        self._parameter_list = params
        self._names = {id(p): name or f"param_{i}"
                       for i, (name, p) in enumerate(named)}
        dev = params[0].device
        self._lr_tensor = torch.full((), lr0, dtype=torch.float32,
                                     device=dev)
        self._step_tensor = torch.zeros((), dtype=torch.float32, device=dev)
        self._step_count = 0
        if self._lr_scheduler is not None:
            self._lr_scheduler.bind(self)
        # a float weight_decay is coupled L2 decay; decoupled optimizers
        # (AdamW) read its coefficient from self._weight_decay instead
        if isinstance(weight_decay, numbers.Real):
            self._weight_decay = weight_decay
            self._regularization = L2Decay(float(weight_decay)) \
                if weight_decay else None
        elif weight_decay is None:
            self._weight_decay = self._regularization = None
        else:                           # an L1Decay / L2Decay object
            self._weight_decay = getattr(weight_decay, "_coeff", None)
            self._regularization = weight_decay
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        # accumulator name -> {id(param): tensor}
        self._accumulators: dict[str, dict[int, torch.Tensor]] = {}
        self._master_weights: dict[int, torch.Tensor] = {}
        self._fuse = bool(fuse)
        self._fused_impl = None

    #: whether ``_append_optimize_op`` keeps f32 master weights under
    #: ``multi_precision`` (the fused step's readiness check reads it)
    _keeps_master = False

    # -- lr -----------------------------------------------------------------
    def get_lr(self) -> float:
        return float(self._lr_tensor)

    def set_lr(self, value: float) -> None:
        if self._lr_scheduler is not None:
            raise RuntimeError("cannot set_lr when an LRScheduler is in use")
        self._set_lr_value(value)

    def _set_lr_value(self, value: float) -> None:
        """Write the rate into the device tensor (a fill kernel: no copy
        from the host, no synchronisation); the scheduler's hook."""
        self._lr_tensor.fill_(float(value))

    def _lr_mult(self, param) -> float:
        """The parameter's ``optimize_attr["learning_rate"]`` (1 without
        one), as ``paddle_tpu/optimizer/optimizer.py:101-105`` reads it."""
        attr = getattr(param, "optimize_attr", None) or {}
        return float(attr.get("learning_rate", 1.0))

    def _lr(self, param=None):
        """The learning rate for ``param``: a 0-d device tensor."""
        mult = 1.0 if param is None else self._lr_mult(param)
        return self._lr_tensor if mult == 1.0 else self._lr_tensor * mult

    def _apply_coupled_weight_decay(self, param, grad):
        """``grad`` with the regularizer's decay of ``param`` added, or
        ``grad`` itself without one."""
        if self._regularization is not None:
            return self._regularization._apply(param, grad)
        return grad

    # -- accumulators -------------------------------------------------------
    def _add_accumulator(self, name, param, fill_value=0.0,
                         dtype=torch.float32):
        accs = self._accumulators.setdefault(name, {})
        acc = accs.get(id(param))
        if acc is None:
            acc = accs[id(param)] = torch.full_like(param, fill_value,
                                                    dtype=dtype)
        return acc

    def _get_master(self, param):
        """The f32 master copy of ``param`` with ``multi_precision``, made
        at first use; None for an f32 parameter or without it."""
        if not self._multi_precision or param.dtype == torch.float32:
            return None
        master = self._master_weights.get(id(param))
        if master is None:
            master = self._master_weights[id(param)] = \
                param.detach().float().clone()
        return master

    # -- core update --------------------------------------------------------
    @torch.no_grad()
    def step(self) -> None:
        """One update of every parameter with a grad: through the fused
        step with ``fuse=True``, else the eager loop."""
        if self._fuse:
            self._fused().step()
        else:
            self._step_unfused()

    def _fused(self):
        if self._fused_impl is None:
            from .fused import FusedOptimizerStep
            self._fused_impl = FusedOptimizerStep(self)
        return self._fused_impl

    def _params_grads(self):
        return [(p, p.grad) for p in self._parameter_list
                if p.requires_grad and p.grad is not None]

    @torch.no_grad()
    def _step_unfused(self) -> None:
        """The eager per-parameter loop (the fused step's warm-up and
        fallback)."""
        self._step_count += 1
        self._update(self._params_grads())

    def _update(self, params_grads) -> None:
        """The device side of a step, and all of what the fused step
        captures: the clip, the device step counter (bias correction sees
        the new value) and every parameter's update. No host read."""
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        self._step_tensor.add_(1.0)
        self._begin_step()
        for p, g in params_grads:
            if g is not None:
                self._append_optimize_op(p, g)

    def _begin_step(self) -> None:
        """Per-step work shared by every parameter (after the counter
        moved)."""

    def _append_optimize_op(self, param, grad) -> None:
        raise NotImplementedError

    def _fused_state_names(self, param):
        """Accumulator names ``_append_optimize_op`` makes for ``param``,
        or None when unknown (a subclass that declares none warms up on
        the first fused step), as ``paddle_tpu/optimizer/optimizer.py:
        163-170``."""
        return None

    def clear_grad(self, set_to_zero: bool = False) -> None:
        for p in self._parameter_list:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``loss.backward()``, :meth:`step`, and ``(None, [(param,
        grad), ...])`` over the parameter list, as the JAX dygraph branch
        returns (``paddle_tpu/optimizer/optimizer.py:212-214``). A
        ``startup_program`` asks for the static-graph branch, which raises:
        ``paddle.static`` is not ported."""
        if startup_program is not None:
            raise NotImplementedError(
                "minimize(startup_program=...) is the static-graph path; "
                "paddle.static is not ported")
        loss.backward()
        self.step()
        return None, [(p, p.grad) for p in self._parameter_list]

    # -- state dict ---------------------------------------------------------
    def state_dict(self) -> dict:
        state = {}
        for acc_name, accs in self._accumulators.items():
            for p in self._parameter_list:
                if id(p) in accs:
                    state[f"{self._names[id(p)]}_{acc_name}"] = accs[id(p)]
        if self._master_weights:
            state["master_weights"] = {
                self._names[id(p)]: self._master_weights[id(p)]
                for p in self._parameter_list
                if id(p) in self._master_weights}
        if self._lr_scheduler is not None:
            state["LR_Scheduler"] = self._lr_scheduler.state_dict()
        state["@step"] = self._step_count
        return state

    def set_state_dict(self, state_dict) -> None:
        if self._fused_impl is not None:
            # state may be new tensors: a captured graph would update the old
            self._fused_impl.invalidate()
        state = dict(state_dict)
        self._step_count = int(state.pop("@step", 0))
        self._step_tensor.fill_(float(self._step_count))
        sched = state.pop("LR_Scheduler", None)
        if sched is not None and self._lr_scheduler is not None:
            self._lr_scheduler.set_state_dict(sched)
        by_name = {self._names[id(p)]: p for p in self._parameter_list}

        def put(store, p, value):
            if not isinstance(value, torch.Tensor):   # numpy, from JAX
                value = torch.tensor(value)
            value = value.to(p.device)
            if id(p) in store:
                store[id(p)].copy_(value)      # in place, as the JAX package
            else:
                store[id(p)] = value.clone()

        for n, w in (state.pop("master_weights", None) or {}).items():
            if n in by_name:
                put(self._master_weights, by_name[n], w)
        unbound = []
        for key, value in state.items():
            # longest-prefix match: 'w_1_moment1' binds to 'w_1', not 'w'
            best = max((n for n in by_name if key.startswith(n + "_")),
                       key=len, default=None)
            if best is None:
                unbound.append(key)
                continue
            acc_name = key[len(best) + 1:]
            put(self._accumulators.setdefault(acc_name, {}), by_name[best],
                value)
        if unbound:
            warnings.warn(
                f"optimizer.set_state_dict: {len(unbound)} state entr"
                f"{'y' if len(unbound) == 1 else 'ies'} matched no parameter "
                f"(e.g. {unbound[0]!r}); accumulators for those parameters "
                f"start fresh", RuntimeWarning)
