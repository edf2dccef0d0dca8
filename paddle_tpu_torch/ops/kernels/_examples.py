"""Small helpers the kernel modules' ``ck_examples()`` share.

A module's ``ck_examples()`` declares the launches of its C entries for
the kernel analyzer (``paddle_tpu_torch/analysis/kernels``): one
:class:`~paddle_tpu_torch.analysis.kernels.model.Example` per shape, at
the JAX module's ``pk_examples()`` shapes and at the shapes phase 3 of
``chip_smoke.py`` times (labels ``phase3 ...``), each with a tail example.
"""

from __future__ import annotations

import torch

__all__ = ["CTYPE", "with_tail", "normal", "uniform", "fixed", "model"]

#: a tensor dtype as ``c++filt`` prints the template argument
CTYPE = {torch.bfloat16: "__nv_bfloat16", torch.float32: "float"}


def model():
    """The analyzer's declaration types (imported when examples are built,
    never when a kernel module is imported)."""
    from ...analysis.kernels import model as m
    return m


def with_tail(build, label: str, shape: dict, tail: dict):
    """``build(label, **shape)`` with ``build(label + " tail", **tail)`` as
    its tail example."""
    ex = build(label, **shape)
    ex.tail = build(f"{label} tail", **tail)
    return ex


def normal(shape, dtype, scale=1.0, shift=0.0):
    """Data: ``shift + scale * N(0, 1)`` in ``dtype``."""
    def make(gen, device):
        return (torch.randn(shape, generator=gen, device=device) * scale
                + shift).to(dtype)
    return make


def uniform(shape, dtype, lo=0.0, hi=1.0):
    """Data: uniform in ``[lo, hi)`` in ``dtype``."""
    def make(gen, device):
        return (torch.rand(shape, generator=gen, device=device) * (hi - lo)
                + lo).to(dtype)
    return make


def fixed(t):
    """Data: a copy of ``t`` (made on the CPU from a seed) on the device."""
    def make(gen, device):
        return t.to(device).clone()
    return make
