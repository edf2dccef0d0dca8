"""Core state of the port (counterpart of ``paddle_tpu/core``): so far the
random generator."""

from . import generator
from .generator import (Generator, default_generator, get_rng_state, seed,
                        set_rng_state)

__all__ = ["Generator", "default_generator", "generator", "get_rng_state",
           "seed", "set_rng_state"]
