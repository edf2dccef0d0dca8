"""Fused optimizer step: on the card, the whole update as one CUDA graph
replayed a step (counterpart of ``paddle_tpu/optimizer/fused.py``).

The JAX package traces the update once into a single ``jax.jit`` program
and dispatches it once a step. Its torch counterpart is a CUDA graph: the
global-norm clip, the device step counter and every parameter, accumulator
and master-weight update (rows 14-15's kernels and the other optimizers'
plain tensor ops) are captured once and replayed, one ``replay()`` a step
whatever the parameter count.

Design, point by point as in JAX:

* **The real code is captured.** The graph is built by running the
  optimizer's own :meth:`Optimizer._update` (the clip, the counter and
  ``_append_optimize_op`` for every parameter) under stream capture, so
  there is no second copy of the update math, and a replay computes the
  eager step's bits.
* **Warm-up.** Optimizers make accumulators and master weights lazily in
  their first update, and an allocation made under capture would hold
  zeros fixed into the graph. So a step on which any parameter has no
  state yet runs eagerly (``warmup``) and makes it. ``_fused_state_names``
  tells state that ``set_state_dict`` restored in place (fuse at once)
  apart from missing state (warm up), as JAX does.
* **Structure cache.** An entry is keyed on the parameters (ids, addresses,
  shapes, dtypes), which grads are present and their dtypes, the lr
  multipliers, the decay exclusions, ``need_clip``, the clip object and its
  settings, the regularizer, the decay coefficients and the device.
  Values ride in device tensors that exist already: ``set_lr`` and the
  schedulers ``fill_`` ``_lr_tensor``, and the graph adds to
  ``_step_tensor`` itself. Adding or removing a parameter, swapping the
  clip or changing the weight decay gives a new key (a new capture). Per
  parameter edits made in place (``optimize_attr``, ``need_clip``, a
  clip's fields) need :meth:`invalidate`; ``set_state_dict`` calls it.
* **Grads at new addresses.** The graph reads the grads it was captured
  with, which the entry holds. ``clear_grad()`` sets ``p.grad = None``, so
  the next backward puts each grad elsewhere: a replay first copies every
  grad whose address differs into the captured one (one multi-tensor
  copy). ``clear_grad(set_to_zero=True)`` keeps the addresses, and then
  nothing is copied. The held grads cost one grad-sized buffer a
  parameter while the caller's grads are elsewhere.
* **Host bookkeeping stays outside the graph.** ``_step_count`` moves on
  the host at every fused step; the kernels' Python launch counters run
  at capture only. :attr:`FusedOptimizerStep.stats` counts ``fused`` steps
  (replays), ``warmup`` steps, ``captures`` (structure entries built: a
  graph on the card) and ``fallbacks``, the counterparts of JAX's
  ``paddle_tpu_optimizer_fused_*`` counters.
* **A capture that fails** (a host read in a subclass's update, an
  operation a graph cannot hold) warns with its cause, is counted in
  ``fallbacks``, and that structure then runs eagerly, as JAX's
  ``test_fused_compile_failure_falls_back_loudly`` expects. A failed
  capture updates nothing, so the eager step that follows applies the
  update once, and it leaves the card's default generator as it found it.
* **On the CPU** there is no graph: the same bookkeeping (warm-up, key,
  stats) runs over the eager loop.

Not ported: the GradScaler scale fold (``step(scale=)``), the buckets'
gauge and donation.
"""

from __future__ import annotations

import warnings
import weakref

import torch

__all__ = ["FusedOptimizerStep"]

#: a cache entry whose capture failed: that structure runs eagerly
_EAGER = "eager"


class _Graph:
    """A captured update: the graph and the grads it reads; ``copies``
    counts the replays that first copied moved grads in."""

    def __init__(self, graph, grads):
        self.graph = graph
        self.grads = grads
        self.copies = 0

    def run(self, params_grads):
        src = [g for _, g in params_grads]
        moved = [i for i, (g, s) in enumerate(zip(src, self.grads))
                 if g.data_ptr() != s.data_ptr()]
        if moved:
            torch._foreach_copy_([self.grads[i] for i in moved],
                                 [src[i] for i in moved])
            self.copies += 1
        self.graph.replay()


class FusedOptimizerStep:
    """Fused-update engine of one optimizer (built by its first ``step()``
    with ``fuse=True``)."""

    def __init__(self, opt):
        self._opt = opt
        self._cache: dict = {}     # structure key -> _Graph, None or _EAGER
        self._warm: dict[int, weakref.ref] = {}
        self._key_memo: dict = {}
        self.stats = {"fused": 0, "warmup": 0, "captures": 0,
                      "fallbacks": 0}

    def invalidate(self) -> None:
        """Drop every captured structure (the next step captures anew)."""
        self._cache.clear()
        self._key_memo.clear()
        self._warm = {i: r for i, r in self._warm.items()
                      if r() is not None}

    def _is_warm(self, p) -> bool:
        ref = self._warm.get(id(p))
        return ref is not None and ref() is p

    def _mark_warm(self, params) -> None:
        for p in params:
            self._warm[id(p)] = weakref.ref(p)

    def _state_ready(self, params_grads) -> bool:
        """Does every accumulator and master weight the update touches
        exist? (After ``set_state_dict`` into a fresh optimizer: yes, and a
        resumed run fuses at once.)"""
        opt = self._opt
        for p, _ in params_grads:
            if self._is_warm(p):
                continue
            names = opt._fused_state_names(p)
            if names is None:
                return False
            if opt._keeps_master and opt._multi_precision \
                    and p.dtype != torch.float32 \
                    and id(p) not in opt._master_weights:
                return False
            if any(id(p) not in opt._accumulators.get(n, {})
                   for n in names):
                return False
            self._mark_warm([p])
        return True

    def _key(self, params_grads):
        opt = self._opt
        clip = opt._grad_clip
        knobs = (id(clip), getattr(clip, "clip_norm", None),
                 getattr(clip, "max", None), getattr(clip, "min", None),
                 id(opt._regularization),
                 getattr(opt._regularization, "_coeff", None),
                 opt._weight_decay, getattr(opt, "_lamb_wd", None),
                 id(getattr(opt, "_apply_decay_param_fun", None)),
                 id(getattr(opt, "_lr_ratio", None)),
                 id(getattr(opt, "_exclude_fn", None)))
        fast = (tuple((id(p), p.data_ptr(), p.shape, p.dtype, g.dtype)
                      for p, g in params_grads), knobs)
        key = self._key_memo.get(fast)
        if key is None:
            per = []
            for p, g in params_grads:
                dec = opt._decoupled_decay_for(p) \
                    if hasattr(opt, "_decoupled_decay_for") else None
                excl = bool(opt._exclude_fn(p)) \
                    if getattr(opt, "_exclude_fn", None) is not None else None
                per.append((id(p), p.data_ptr(), tuple(p.shape), p.dtype,
                            tuple(g.shape), g.dtype, opt._lr_mult(p), dec,
                            excl, getattr(p, "need_clip", True)))
            key = (tuple(per), knobs, type(clip).__name__,
                   tuple(sorted(opt._accumulators)),
                   params_grads[0][0].device.type)
            if len(self._key_memo) > 8:
                self._key_memo.clear()
            self._key_memo[fast] = key
        return key

    def step(self) -> None:
        """One update over every parameter with a grad: an eager warm-up,
        a graph replay (a capture first for a new structure), or the eager
        loop (on the CPU, or for a structure whose capture failed)."""
        opt = self._opt
        params_grads = opt._params_grads()
        if not params_grads:
            opt._step_unfused()      # the counters still advance
            return
        if not self._state_ready(params_grads):
            opt._step_unfused()
            self._mark_warm([p for p, _ in params_grads])
            self.stats["warmup"] += 1
            return
        key = self._key(params_grads)
        if key not in self._cache:
            if len(self._cache) >= 4:
                # each entry holds its grads (and a graph pool): older
                # structures are parameter churn
                self.invalidate()
            self._cache[key] = self._capture(params_grads)
        entry = self._cache[key]
        if entry is _EAGER:
            opt._step_unfused()
            return
        if entry is None:            # the CPU: the eager loop
            opt._update(params_grads)
        else:
            entry.run(params_grads)
        opt._step_count += 1
        self.stats["fused"] += 1

    def _capture(self, params_grads):
        """The entry of a new structure: None on the CPU, else the update
        captured into a CUDA graph, or ``_EAGER`` if the capture failed."""
        self.stats["captures"] += 1
        if not self._graphable(params_grads):
            return None
        try:
            return self._graph(params_grads)
        except Exception as e:       # noqa: BLE001 -- reported, then eager
            warnings.warn(
                f"fused optimizer step: capturing the update failed "
                f"({type(e).__name__}: {e}); {type(self._opt).__name__} "
                f"runs this parameter structure eagerly", RuntimeWarning)
            self.stats["fallbacks"] += 1
            return _EAGER

    @staticmethod
    def _graphable(params_grads) -> bool:
        return params_grads[0][0].device.type == "cuda"

    def _graph(self, params_grads):
        """``_update`` captured on a side stream into a graph with its own
        memory pool; the graph reads the grads given here."""
        grads = [g for _, g in params_grads]
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        rng = torch.cuda.default_generators[torch.cuda.current_device()]
        rng_state = rng.clone_state()
        try:
            with torch.cuda.stream(side):
                graph.capture_begin()
                try:
                    self._opt._update(list(params_grads))
                finally:
                    graph.capture_end()
        except Exception:
            # a capture that fails leaves the default generator marked as
            # capturing, and every later draw on the card would raise
            rng.graphsafe_set_state(rng_state)
            raise
        finally:
            torch.cuda.current_stream().wait_stream(side)
        return _Graph(graph, grads)
