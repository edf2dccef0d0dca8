"""The port's device presets and kernel costs (counterpart of
``paddle_tpu/cost_model/collective.py:87-141`` ``CHIP_PRESETS``,
``chip_vmem_bytes`` and ``roofline_ms``, and
``paddle_tpu/cost_model/__init__.py:32`` ``kernel_cost``).

A preset holds what the kernel analyzer judges a launch against (shared
memory a block may opt into, registers, threads and blocks a
multiprocessor holds) and the peaks a kernel's bound is taken from: the
memory rate and the operation rate of the units that do its work (f32
outside the tensor cores, bf16 and int8 on them). The H100's numbers are
NVIDIA's data sheet (SXM part, dense rates) and the CUDA programming
guide's table for compute capability 9.0. :func:`check_preset` holds a
preset against the card it runs on.
"""

from __future__ import annotations

import ctypes
import os

__all__ = ["DEVICE_PRESETS", "device_preset", "smem_per_block_bytes",
           "roofline_ms", "kernel_cost", "check_preset"]

_KB = 1024

DEVICE_PRESETS = {
    "h100": {
        "sms": 132,
        "smem_per_block_optin": 227 * _KB,   # 232,448 B
        "smem_per_sm": 228 * _KB,            # 233,472 B
        "smem_reserved_per_block": 1 * _KB,
        "smem_granularity": 128,
        "regs_per_sm": 65536,
        "reg_granularity": 256,              # a warp's registers come in 256s
        "threads_per_sm": 2048,
        "threads_per_block": 1024,
        "blocks_per_sm": 32,
        "mem_bytes_per_s": 3.35e12,
        "flops_per_s": {"f32": 67e12, "bf16": 989e12, "int8": 1979e12},
    },
}

#: the preset's fields that the card reports, and how to read each:
#: (torch.cuda.get_device_properties attribute, cudaDeviceAttr number)
_CARD_FIELDS = {
    "sms": ("multi_processor_count", 16),
    "smem_per_block_optin": ("shared_memory_per_block_optin", 97),
    "smem_per_sm": ("shared_memory_per_multiprocessor", 81),
    "smem_reserved_per_block": (None, 111),
    "regs_per_sm": ("regs_per_multiprocessor", 82),
    "threads_per_sm": ("max_threads_per_multi_processor", 39),
    "threads_per_block": (None, 1),
    "blocks_per_sm": (None, 106),
}


def device_preset(name: str = "h100") -> dict:
    """The preset ``name``; an unknown name raises."""
    try:
        return DEVICE_PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown device preset {name!r} "
                       f"(have {sorted(DEVICE_PRESETS)})") from None


def smem_per_block_bytes(name: str = "h100") -> int:
    """Shared memory one block may use after opting in (the counterpart of
    ``chip_vmem_bytes``): the budget of rule CK200."""
    return int(device_preset(name)["smem_per_block_optin"])


def roofline_ms(flops: float, nbytes: float, unit: str = "f32",
                name: str = "h100") -> float:
    """The least time the card could take: the larger of ``nbytes`` over
    the memory rate and ``flops`` over the peak of ``unit`` (``f32``,
    ``bf16`` or ``int8``), in milliseconds."""
    p = device_preset(name)
    return max(float(nbytes) / p["mem_bytes_per_s"],
               float(flops) / p["flops_per_s"][unit]) * 1e3


def kernel_cost(module_or_path, device=None) -> dict:
    """Resource sheets of one kernel module's ``ck_examples()`` (see
    :func:`paddle_tpu_torch.analysis.kernels.kernel_cost`)."""
    from ..analysis.kernels import kernel_cost as _impl
    return _impl(module_or_path, device=device)


def _cudart():
    for cand in ("libcudart.so", "libcudart.so.12",
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "lib64", "libcudart.so")):
        try:
            return ctypes.CDLL(cand)
        except OSError:
            continue
    raise RuntimeError("the CUDA runtime library (libcudart) is not loadable")


def check_preset(name: str = "h100") -> dict:
    """``{field: (preset value, card value)}`` for every field where the
    preset and the first card differ (empty when they agree). Reads
    ``torch.cuda.get_device_properties`` and, for what torch does not
    expose, ``cudaDeviceGetAttribute``; raises without a card."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("check_preset needs a CUDA device")
    p = device_preset(name)
    props = torch.cuda.get_device_properties(0)
    rt = None
    diffs = {}
    for field, (attr, number) in _CARD_FIELDS.items():
        if attr is not None and hasattr(props, attr):
            value = int(getattr(props, attr))
        else:
            rt = rt or _cudart()
            v = ctypes.c_int()
            err = rt.cudaDeviceGetAttribute(ctypes.byref(v), number, 0)
            if err:
                raise RuntimeError(f"cudaDeviceGetAttribute({number}) "
                                   f"failed with cudaError {err}")
            value = v.value
        if value != p[field]:
            diffs[field] = (p[field], value)
    return diffs
