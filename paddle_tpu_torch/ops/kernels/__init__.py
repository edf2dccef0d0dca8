"""Hand-written Hopper kernels, one module each beside its plain version.

Each wrapper takes the plain PyTorch version for a tensor on the CPU and
launches its CUDA kernel for a tensor on the card (or raises), and counts
its launches in a plain ``int`` attribute, ``<wrapper>.launches``.
"""

from . import (block_epilogue, decode_layer, flash_attention, mmha, rms_norm,
               rope, swiglu)

#: every kernel wrapper of the port, by name
WRAPPERS = {"mmha": mmha.mmha_decode, "rms_norm": rms_norm.rms_norm,
            "rope": rope.rope_apply, "swiglu": swiglu.swiglu,
            "flash_attention": flash_attention.flash_attention,
            "block_epilogue": block_epilogue.fused_epilogue,
            "decode_layer": decode_layer.decode_layer}

__all__ = ["WRAPPERS", "block_epilogue", "decode_layer", "flash_attention",
           "mmha", "rms_norm", "rope", "swiglu"]
