"""Layers and functional ops of the port."""

from . import clip, functional, layers, loss, quant
from .layers import *  # noqa: F401,F403 -- the loss layers

__all__ = ["clip", "functional", "layers", "loss", "quant"] + layers.__all__
