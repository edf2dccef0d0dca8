"""The port's random state (counterpart of ``paddle_tpu/core/generator.py``
``Generator``, ``seed``, ``get_rng_state`` and ``set_rng_state``, :29-130).

JAX keeps one splittable threefry key and draws each random op from a
fresh split. Here the default :class:`Generator` holds explicit
``torch.Generator`` s, all seeded by :func:`seed`: one on the CPU for host
draws (a dropout kernel's int32 seed is drawn there, so drawing it never
waits for the card) and one per CUDA device for masks drawn on that
device. The bits differ from ``jax.random``'s for the same seed; tests
that compare the two hand both the same numpy inputs.

``RNGStatesTracker`` (the named streams of tensor-parallel dropout) is not
ported yet.
"""

from __future__ import annotations

import threading

import torch

__all__ = ["Generator", "default_generator", "seed", "get_rng_state",
           "set_rng_state"]

#: the int32 seeds a dropout kernel takes lie in [0, 2**31 - 1), as JAX's
#: ``jax.random.randint(key, (), 0, 2147483647)``
_SEED_HIGH = 2147483647


class Generator:
    """Stateful random state over ``torch.Generator`` s, one per device,
    made at first use and seeded from :meth:`initial_seed`."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self._seed = int(seed)
        self._gens: dict[torch.device, torch.Generator] = {}

    @staticmethod
    def _key(device) -> torch.device:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev

    def manual_seed(self, seed: int) -> "Generator":
        """Reseed every device's generator with ``seed``."""
        with self._lock:
            self._seed = int(seed)
            for gen in self._gens.values():
                gen.manual_seed(self._seed)
        return self

    def initial_seed(self) -> int:
        return self._seed

    def generator(self, device="cpu") -> torch.Generator:
        """The ``torch.Generator`` that draws on ``device``."""
        key = self._key(device)
        with self._lock:
            gen = self._gens.get(key)
            if gen is None:
                gen = torch.Generator(device=key).manual_seed(self._seed)
                self._gens[key] = gen
            return gen

    def random(self) -> int:
        """A fresh int32 seed in ``[0, 2**31 - 1)``, drawn on the host."""
        return int(torch.randint(0, _SEED_HIGH, (),
                                 generator=self.generator("cpu")))

    def get_state(self):
        """``(seed, {device: generator state})``; restored by
        :meth:`set_state`."""
        with self._lock:
            return (self._seed, {str(dev): gen.get_state()
                                 for dev, gen in self._gens.items()})

    def set_state(self, state) -> None:
        seed_, states = state
        with self._lock:
            self._seed = int(seed_)
            self._gens.clear()
        for dev, st in states.items():
            self.generator(dev).set_state(st)


default_generator = Generator(0)


def seed(s: int) -> Generator:
    """``paddle.seed``: reseed the default generator."""
    return default_generator.manual_seed(s)


def get_rng_state():
    return default_generator.get_state()


def set_rng_state(state) -> None:
    default_generator.set_state(state)
