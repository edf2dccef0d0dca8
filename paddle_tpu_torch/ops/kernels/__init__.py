"""Hand-written Hopper kernels, one module each beside its plain version.

Each wrapper takes the plain PyTorch version for a tensor on the CPU and
launches its CUDA kernel for a tensor on the card (or raises), and counts
its launches in a plain ``int`` attribute, ``<wrapper>.launches``.
"""

from . import (a8w8_matmul, adamw, bias_dropout_ln, block_epilogue,
               decode_layer, dropout_add, flash_attention, lamb,
               linear_grad_add, mmha, moe_gemm, parallel_ce, rms_norm, rope,
               softmax_mask, swiglu, wo_matmul)

#: every kernel wrapper of the port, by name
WRAPPERS = {"mmha": mmha.mmha_decode, "rms_norm": rms_norm.rms_norm,
            "rms_norm_bwd": rms_norm.rms_norm_bwd,
            "rope": rope.rope_qk, "swiglu": swiglu.swiglu,
            "swiglu_bwd": swiglu.swiglu_bwd,
            "swiglu_packed": swiglu.swiglu_packed,
            "swiglu_packed_bwd": swiglu.swiglu_packed_bwd,
            "flash_attention": flash_attention.flash_attention,
            "flash_attention_bwd": flash_attention.flash_attention_bwd,
            "block_epilogue": block_epilogue.fused_epilogue,
            "block_epilogue_bwd": block_epilogue.fused_epilogue_bwd,
            "decode_layer": decode_layer.decode_layer,
            "wo_int8": wo_matmul.wo_int8,
            "wo_int8_grouped": wo_matmul.wo_int8_grouped,
            "wo_int4": wo_matmul.wo_int4,
            "a8w8": a8w8_matmul.a8w8_matmul,
            "adamw": adamw.adamw_update,
            "lamb": lamb.lamb_update,
            "parallel_ce": parallel_ce.row_stats,
            "moe_gemm": moe_gemm.grouped_matmul,
            "softmax_mask": softmax_mask.softmax_mask,
            "softmax_mask_tri": softmax_mask.softmax_mask_tri,
            "softmax_mask_bwd": softmax_mask.softmax_mask_bwd,
            "bias_dropout_ln": bias_dropout_ln.bias_dropout_ln,
            "bias_dropout_ln_bwd": bias_dropout_ln.bias_dropout_ln_bwd,
            "dropout_add": dropout_add.dropout_add,
            "dropout_add_bwd": dropout_add.dropout_add_bwd,
            "linear_grad_add": linear_grad_add.linear_grad_add}

__all__ = ["WRAPPERS", "a8w8_matmul", "adamw", "bias_dropout_ln",
           "block_epilogue", "decode_layer", "dropout_add", "flash_attention",
           "lamb", "linear_grad_add", "mmha", "moe_gemm", "parallel_ce",
           "rms_norm", "rope", "softmax_mask", "swiglu", "wo_matmul"]
