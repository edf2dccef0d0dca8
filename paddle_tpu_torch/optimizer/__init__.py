"""Optimizers and learning-rate schedulers of the port (counterpart of
``paddle_tpu/optimizer``)."""

from . import lr
from .optimizer import Optimizer
from .optimizers import (LBFGS, SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,
                         Lamb, Momentum, RMSProp)

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "Adadelta", "Adamax", "RMSProp", "Lamb", "LBFGS"]
