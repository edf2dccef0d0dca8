"""paddle_tpu_torch's quantized serving with the fused decode layer against the
JAX engine, on the CPU (split from ``test_torch_quant_serving.py``, whose
helpers and tolerances it shares).
"""


import numpy as np
import pytest
import torch

from paddle_tpu.ops.kernels import _common as jax_kern
from paddle_tpu_torch.serving import ServingModel

from test_torch_quant_serving import (  # noqa: F401 — shared helpers
    _PROMPTS, _QUANTS, _jax_tokens, _port, models, no_tune)


@pytest.mark.parametrize("quant,group", _QUANTS[:3])
def test_quant_fused_layer_engine_tokens_equal_jax(models, no_tune, quant,
                                                   group):
    """``quant`` with ``fused_decode_layer=True``: the decode-layer kernel
    reads o/gate/up/down dequantized once at construction, q/k/v keep the
    weight-only kernels; token-exact against the JAX fused-layer engine."""
    jm, tm = models
    want = _jax_tokens(jm, _PROMPTS, interpret=True, fused_decode_layer=True,
                       quant=quant, quant_group_size=group)
    got, _, summary, eng = _port(tm, _PROMPTS, fused_decode_layer=True,
                                 quant=quant, quant_group_size=group)
    sm = eng._sm
    assert sm._fused_layer_active() and sm.quantized
    assert len(sm._dq_weights) == 4 * tm.cfg.num_layers
    assert got == want, (quant, group)
    assert summary["pages_leaked"] == 0


def test_fused_layer_dequantized_weights_are_jax_values(models):
    """On the f32 model the decode-layer kernel's weights are exactly the
    JAX engine's dequantized values, transposed to ``[out, in]``."""
    jm, tm = models
    from paddle_tpu.serving.model import ServingModel as JaxServingModel
    jax_kern.force_interpret(True)
    try:
        jsm = JaxServingModel(jm, quant="weight_only_int8", quant_group_size=4,
                              fused_decode_layer=True)
    finally:
        jax_kern.force_interpret(False)
    sm = ServingModel(tm, quant="weight_only_int8", quant_group_size=4,
                      fused_decode_layer=True)
    for key, want in jsm._dq_weights.items():
        got = sm._dq_weights[key]
        assert got.dtype == torch.float32 and got.is_contiguous()
        np.testing.assert_array_equal(got.t().numpy(),
                                      np.asarray(want.numpy()))
