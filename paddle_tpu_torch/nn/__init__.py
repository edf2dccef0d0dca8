"""Layers and functional ops of the port."""

from . import clip, functional, quant

__all__ = ["clip", "functional", "quant"]
