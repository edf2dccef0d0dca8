"""Optimizers of the port (counterpart of ``paddle_tpu/optimizer``)."""

from .optimizer import Optimizer
from .optimizers import Adam, AdamW

__all__ = ["Optimizer", "Adam", "AdamW"]
