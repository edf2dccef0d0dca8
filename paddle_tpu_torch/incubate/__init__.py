"""Incubating APIs of the port (counterpart of ``paddle_tpu/incubate``):
so far the mixture-of-experts layer, ``incubate.distributed.models.moe``."""

from . import distributed

__all__ = ["distributed"]
