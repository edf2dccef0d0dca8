"""Model-parallel layers (counterpart of
``paddle_tpu/distributed/meta_parallel/__init__.py``)."""

from .mp_layers import ParallelCrossEntropy

__all__ = ["ParallelCrossEntropy"]
