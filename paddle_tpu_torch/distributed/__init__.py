"""Distributed layers of the port (counterpart of ``paddle_tpu/distributed``):
only the single-device path of ``ParallelCrossEntropy`` so far."""

from . import meta_parallel
from .meta_parallel import ParallelCrossEntropy

__all__ = ["meta_parallel", "ParallelCrossEntropy"]
