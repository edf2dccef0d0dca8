"""Mixture-of-experts layer (counterpart of
``paddle_tpu/incubate/distributed/models/moe/moe_layer.py`` ``MoELayer``,
whose forward is :114-183).

The function is the JAX package's GShard routing:

- softmax of the gate's logits in f32, the top ``k`` experts of each token,
  their weights renormalised to sum to 1;
- ``capacity = max(ceil(capacity_factor * n * k / E), 1)`` slots an
  expert, filled in arrival order: the cumulative count over the flattened
  ``[n * k]`` routing slots, token-major, so a token's second choice queues
  after the first choices of every earlier token (:139-141); a slot past
  the capacity is dropped;
- each expert's FFN on its ``[C, H]`` slots; a token's output is the f32
  sum of its kept ``weight * expert_out`` terms, cast to the token dtype;
- ``l_aux = E * sum(mean(probs) * mean(route fraction))``, the route
  fraction taken before the capacity drop (:173-175);
- shared experts added to every token's output.

The port differs in form, not in function: it dispatches and combines by
index, where the JAX package contracts one-hot ``[n, E, C]`` dispatch and
combine tensors with einsums (two ``[n, E, C, H]`` f32 contractions a
layer, ~280 GFLOP at n = 2048 on Qwen1.5-MoE's widths, more than the expert
products). Each ``(e, c)`` slot holds at most one token, so the dispatch
einsum is an exact gather, done here as one ``index_copy`` into a zeroed
``[E, C, H]`` buffer (dropped slots go to one spill row past the buffer);
the combine is a gather of each token's ``k`` slots and a weighted f32 sum
(a dropped slot weighs 0), the same terms the einsum adds.

SwiGLU experts (parameters ``gate_proj.weight``, ``up_proj.weight``,
``down_proj.weight``, the JAX test at :99-100) run through the grouped
product (``ops/kernels/moe_gemm.py``, TPU row 17) three times, with the
kept slots per expert as its counts, and the SwiGLU gate between; any other
expert template runs once per expert through ``torch.func.functional_call``
on its slice of the stacked parameters, the counterpart of JAX's ``vmap``
(:164-166). The stacked parameters ``expert_0``, ``expert_1``, ... keep the
JAX package's layout: a linear weight is ``[E, in, out]``, the grouped
kernel's layout (``torch.nn.Linear`` keeps ``[out, in]``).

The port has no device mesh: ``moe_group`` or ``mp_group`` other than
None raises ``NotImplementedError``; ``expert_parallel_axis`` is accepted
and gives one expert rank, as the JAX layer does without a mesh (:69-74).
"""

from __future__ import annotations

import inspect
import math

import torch
from torch import nn
from torch.func import functional_call

from .....nn import functional as F
from .....ops.kernels import moe_gemm as _moe
from .gate import GShardGate, NaiveGate, SwitchGate

__all__ = ["MoELayer"]

_SWIGLU = ["gate_proj.weight", "up_proj.weight", "down_proj.weight"]


def _linear_weights(template) -> set:
    """Names of ``template``'s ``torch.nn.Linear`` weights."""
    return {f"{name}.weight" if name else "weight"
            for name, mod in template.named_modules()
            if isinstance(mod, nn.Linear)}


def _grouped(x, w, counts, plain):
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _moe.GroupedMatmulFunction.apply(x, w, counts, plain)
    fn = _moe.grouped_matmul_plain if plain else _moe.grouped_matmul
    return fn(x, w, counts)


class MoELayer(nn.Module):
    """``experts`` is the list of expert modules (one template, E copies);
    their parameters are stacked into ``expert_<j>``. ``gate`` is a gate
    module, or a dict ``{"type": "naive" | "gshard" | "switch", "top_k":
    k}`` (default GShard)."""

    def __init__(self, d_model, experts, gate=None, moe_group=None,
                 mp_group=None, recompute_interval=0, top_k=2,
                 capacity_factor=1.25, expert_parallel_axis="dp",
                 shared_experts=None, name=None):
        super().__init__()
        if moe_group is not None or mp_group is not None:
            raise NotImplementedError(
                "MoELayer: moe_group and mp_group shard the experts over a "
                "device mesh, which the port does not have yet (ROADMAP "
                "Queue 1, the breadth of the framework: distributed); leave "
                "both None")
        self.d_model = d_model
        self.num_expert = len(experts)
        self.capacity_factor = capacity_factor
        if gate is None or isinstance(gate, dict):
            cfg = gate or {}
            cls = {"naive": NaiveGate, "gshard": GShardGate,
                   "switch": SwitchGate}[cfg.get("type", "gshard")]
            gate = cls(d_model, self.num_expert, top_k=cfg.get("top_k", top_k))
        self.gate = gate
        self.top_k = gate.top_k
        self.shared_experts = shared_experts
        self._shared_plain = shared_experts is not None and "plain" in \
            inspect.signature(shared_experts.forward).parameters
        template = experts[0]
        self._param_names = [n for n, _ in template.named_parameters()]
        self._ffn_fast = self._param_names == _SWIGLU
        self._transposed = _linear_weights(template)
        self._template = [template]     # not a submodule: no state of its own
        for j, pname in enumerate(self._param_names):
            per = [dict(ex.named_parameters())[pname].detach()
                   for ex in experts]
            if pname in self._transposed:
                per = [p.t() for p in per]
            self.register_parameter(f"expert_{j}",
                                    nn.Parameter(torch.stack(per, 0)))
        #: the load-balance loss and the kept slots per expert (int32
        #: ``[E]``, on the device) of the last forward
        self.l_aux = None
        self.counts = None

    @property
    def stacked(self) -> list:
        """The stacked expert parameters, ``expert_0``, ``expert_1``, ..."""
        return [getattr(self, f"expert_{j}")
                for j in range(len(self._param_names))]

    def _expert_ffn(self, expert_in, counts, plain):
        stacked = self.stacked
        if self._ffn_fast:
            w_gate, w_up, w_down = stacked
            gh = _grouped(expert_in, w_gate, counts, plain)
            uh = _grouped(expert_in, w_up, counts, plain)
            act = F.swiglu(gh, uh, plain=plain)
            return _grouped(act, w_down, counts, plain)
        template = self._template[0]
        outs = []
        for i in range(self.num_expert):
            params = {name: p[i].t() if name in self._transposed else p[i]
                      for name, p in zip(self._param_names, stacked)}
            outs.append(functional_call(template, params, (expert_in[i],)))
        return torch.stack(outs)

    def forward(self, x, plain=False):
        """``x [..., d_model]`` -> the same shape; sets ``self.l_aux``.
        ``plain=True`` runs every kernel's plain version."""
        b_shape = x.shape
        h = self.d_model
        tokens = x.reshape(-1, h)
        n = tokens.shape[0]
        e, k = self.num_expert, self.top_k
        capacity = max(int(math.ceil(self.capacity_factor * n * k / e)), 1)

        probs = torch.softmax(self.gate(tokens).float(), dim=-1)   # [n, e]
        topv, topi = torch.topk(probs, k, dim=-1)                  # [n, k]
        topv = topv / topv.sum(-1, keepdim=True)
        route_oh = torch.nn.functional.one_hot(topi, e)            # [n, k, e]
        slot = topi.reshape(-1)                                    # token-major
        # arrival order: earlier slots routed to the same expert, a scan
        # along the inner dim of [e, n*k] (a scan over the outer dim of
        # [n*k, e] runs one thread a column: 1.5 ms a layer on the H100)
        mine = (torch.arange(e, device=x.device)[:, None]
                == slot[None, :]).to(torch.int32)
        pos = (mine.cumsum(1) - mine).gather(0, slot[None, :])[0]
        keep = pos < capacity
        counts = torch.zeros(e, dtype=torch.int32, device=x.device)
        counts.scatter_add_(0, slot, keep.to(torch.int32))
        self.counts = counts
        dest = torch.where(keep, slot * capacity + pos, e * capacity)

        buf = tokens.new_zeros(e * capacity + 1, h).index_copy(
            0, dest, tokens.repeat_interleave(k, dim=0))
        expert_in = buf[:e * capacity].view(e, capacity, h)
        expert_out = self._expert_ffn(expert_in, counts, plain)
        picked = expert_out.reshape(e * capacity, h).index_select(
            0, torch.where(keep, dest, 0))                         # [n*k, h]
        weight = torch.where(keep, topv.reshape(-1), 0.0)
        out = (weight[:, None] * picked.float()).reshape(n, k, h).sum(1)
        out = out.to(tokens.dtype).reshape(b_shape)

        me = probs.mean(0)
        ce = (route_oh.sum(1).float() / k).mean(0)
        self.l_aux = (me * ce).sum() * e
        if self.shared_experts is not None:
            out = out + (self.shared_experts(x, plain=plain)
                         if self._shared_plain else self.shared_experts(x))
        return out
