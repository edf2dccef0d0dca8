"""MoE-aware global-norm clip (counterpart of
``paddle_tpu/incubate/distributed/models/moe/grad_clip.py``).

Every expert lives in one stacked ``[E, ...]`` parameter on one device, so
the plain global norm already sums each expert's gradient exactly once, as
in the JAX package (``grad_clip.py:1-12``). ``is_expert_param_func`` and
``moe_group`` are kept and not read.
"""

from __future__ import annotations

from .....nn.clip import ClipGradByGlobalNorm

__all__ = ["ClipGradForMOEByGlobalNorm"]


class ClipGradForMOEByGlobalNorm(ClipGradByGlobalNorm):
    def __init__(self, clip_norm, is_expert_param_func=None, moe_group=None,
                 group_name="default_moe_group"):
        super().__init__(clip_norm, group_name)
        self.is_expert_param_func = is_expert_param_func
        self.moe_group = moe_group
