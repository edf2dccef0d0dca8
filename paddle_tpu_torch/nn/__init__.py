"""Layers and functional ops of the port."""

from . import functional, quant

__all__ = ["functional", "quant"]
