"""``ParallelCrossEntropy`` (counterpart of
``paddle_tpu/distributed/meta_parallel/mp_layers.py`` :118-155), its
single-device path.

The per-row softmax cross entropy of logits ``[.., V]`` runs through the
row-statistics kernel (``ops/kernels/parallel_ce.py``), as the JAX layer's
single-device path runs through ``ce_pallas.c_softmax_with_cross_entropy``
(:135-150). The port has no device mesh: an ``mp_group`` other than None,
which would shard the vocab over devices, raises. The rest of
``mp_layers.py`` (the vocab- and column-parallel layers) is not ported.
"""

from __future__ import annotations

import torch

from ...ops.kernels.parallel_ce import c_softmax_with_cross_entropy

__all__ = ["ParallelCrossEntropy"]


class ParallelCrossEntropy(torch.nn.Module):
    """Per-row loss ``[..]`` (f32) of logits ``[.., V]`` and int labels
    ``[..]`` or ``[.., 1]``; rows labelled ``ignore_index`` give loss 0
    and zero gradients. ``plain=True`` in the call runs the kernel's plain
    version on any device (to hold the kernel path against it)."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        if mp_group is not None:
            raise NotImplementedError(
                "ParallelCrossEntropy(mp_group=...): the vocab-sharded path "
                "needs a device mesh, which the port does not have yet")
        self.ignore_index = ignore_index

    def forward(self, input, label, plain=False):
        if label.dim() == input.dim():     # [.., 1] labels
            label = label[..., 0]
        return c_softmax_with_cross_entropy(input, label, 0,
                                            self.ignore_index, plain)
