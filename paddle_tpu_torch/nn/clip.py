"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py``
``ClipGradByValue`` :21, ``ClipGradByNorm`` :37 and
``ClipGradByGlobalNorm`` :52), in plain PyTorch.

A clip object is given to an optimizer as ``grad_clip=`` and applied to
its ``(param, grad)`` list before the update. Everything stays on the
device: every norm is a 0-d tensor, nothing synchronises and no branch
reads a tensor's value, so each clip can be captured into the fused
step's CUDA graph (``optimizer/fused.py``).
"""

from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Clamp every gradient entry to ``[min, max]`` (``min`` defaults to
    ``-max``)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params_grads):
        return [(p, g if g is None else g.clamp(self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Scale each gradient by ``min(clip_norm / max(norm, 1e-12), 1)``,
    its own L2 norm taken in f32."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            norm = torch.sqrt(g.float().square().sum())
            scale = torch.clamp(self.clip_norm / norm.clamp_min(1e-12),
                                max=1.0)
            out.append((p, g * scale.to(g.dtype)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale every gradient by ``min(clip_norm / max(global_norm, 1e-12),
    1)``, where the global norm is taken in f32 over all gradients. A
    parameter with ``need_clip = False`` is left out of the norm and of the
    scaling. New gradient tensors are returned; ``param.grad`` is left as
    it is."""

    #: the global norm of the most recent call (a 0-d f32 tensor on the
    #: gradients' device), None before any call or when nothing was clipped
    last_global_norm = None

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        clipped = [g is not None and getattr(p, "need_clip", True)
                   for p, g in params_grads]
        sq = [g.float().square().sum()
              for (_, g), c in zip(params_grads, clipped) if c]
        if not sq:
            self.last_global_norm = None
            return params_grads
        global_norm = torch.sqrt(torch.stack(sq).sum())
        self.last_global_norm = global_norm
        scale = torch.clamp(self.clip_norm / global_norm.clamp_min(1e-12),
                            max=1.0)
        return [(p, g * scale.to(g.dtype)) if c else (p, g)
                for (p, g), c in zip(params_grads, clipped)]
