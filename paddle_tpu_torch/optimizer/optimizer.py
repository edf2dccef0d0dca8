"""Optimizer base class (counterpart of
``paddle_tpu/optimizer/optimizer.py`` ``Optimizer`` :25-240).

An optimizer holds a parameter list, reads ``param.grad`` filled by
``loss.backward()``, applies the gradient clip and updates the parameters
in place. The learning rate and the step count live in 0-d f32 tensors on
the parameters' device, so ``set_lr`` and the bias correction never leave
the device and :meth:`Optimizer.step` does not synchronise. With
``multi_precision=True`` every parameter that is not f32 gets an f32
master copy, which the update reads and writes; the parameter is written
from it.

Ported: ``parameters=`` (a list, or groups ``[{"params": [...]}, ...]``,
flattened as the JAX package does), a float learning rate with
``get_lr``/``set_lr``, the device step counter, master weights,
``grad_clip``, ``step``, ``clear_grad(set_to_zero)`` and
``state_dict``/``set_state_dict`` under the JAX key names
(``<name>_moment1``, ``master_weights``, ``@step``). ``weight_decay`` is a
float or None. A parameter's name is
its ``name`` attribute where it has one, else ``param_<i>`` by its place
in the list. Not ported yet, and raising: an ``LRScheduler`` as the
learning rate, ``fuse=True`` (the multi-tensor step of
``optimizer/fused.py``) and ``minimize`` (the static-graph path).
"""

from __future__ import annotations

import numbers
import warnings

import torch

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
        if not params:
            raise ValueError("the optimizer got an empty parameter list")
        if not isinstance(learning_rate, numbers.Real):
            raise NotImplementedError(
                "an LRScheduler as the learning rate is not ported yet; "
                "pass a float and call set_lr")
        if fuse:
            raise NotImplementedError(
                "fuse=True (the multi-tensor step of paddle_tpu/optimizer/"
                "fused.py) is not ported yet")
        self._parameter_list = params
        self._names = {id(p): getattr(p, "name", None) or f"param_{i}"
                       for i, p in enumerate(params)}
        dev = params[0].device
        self._lr_tensor = torch.tensor(float(learning_rate),
                                       dtype=torch.float32, device=dev)
        self._step_tensor = torch.zeros((), dtype=torch.float32, device=dev)
        self._step_count = 0
        if not (weight_decay is None
                or isinstance(weight_decay, numbers.Real)):
            raise NotImplementedError(
                "weight_decay takes a float (regularizer objects are not "
                "ported yet)")
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        # accumulator name -> {id(param): tensor}
        self._accumulators: dict[str, dict[int, torch.Tensor]] = {}
        self._master_weights: dict[int, torch.Tensor] = {}

    # -- lr -----------------------------------------------------------------
    def get_lr(self) -> float:
        return float(self._lr_tensor)

    def set_lr(self, value: float) -> None:
        self._lr_tensor.fill_(float(value))

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
        params_grads = [(p, p.grad) for p in self._parameter_list
                        if p.requires_grad and p.grad is not None]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        self._step_count += 1
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

    def clear_grad(self, set_to_zero: bool = False) -> None:
        for p in self._parameter_list:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        raise NotImplementedError(
            "minimize (the static-graph path) is not ported yet: call "
            "loss.backward() and step()")

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
        state["@step"] = self._step_count
        return state

    def set_state_dict(self, state_dict) -> None:
        state = dict(state_dict)
        self._step_count = int(state.pop("@step", 0))
        self._step_tensor.fill_(float(self._step_count))
        if state.pop("LR_Scheduler", None) is not None:
            raise NotImplementedError("LRScheduler state is not ported yet")
        by_name = {self._names[id(p)]: p for p in self._parameter_list}

        def put(store, p, value):
            value = torch.as_tensor(value).to(p.device)
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
