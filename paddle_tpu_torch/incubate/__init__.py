"""Incubating APIs of the port (counterpart of ``paddle_tpu/incubate``):
the mixture-of-experts layer (``incubate.distributed.models.moe``), the
masked softmax (``softmax_mask_fuse``, ``softmax_mask_fuse_upper_triangle``)
and the fused layers and functions of ``incubate.nn``."""

from . import distributed, nn, operators
from .operators import softmax_mask_fuse, softmax_mask_fuse_upper_triangle

__all__ = ["distributed", "nn", "operators", "softmax_mask_fuse",
           "softmax_mask_fuse_upper_triangle"]
