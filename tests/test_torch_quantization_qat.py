"""paddle_tpu_torch's QAT against the JAX package's, on the CPU (beside
``test_torch_quantization.py``, whose helpers and tolerances it shares):
the JAX test's ``Sequential(Linear(8, 32), ReLU, Linear(32, 4))`` quantized
with absmax fake quanters on both sides, weights carried across
transposed; five Adam steps give the same losses and quanter scales (1e-5
relative); ``convert`` and a second ``quantize`` as JAX's.
"""


import numpy as np
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.quantization as JQZ
from paddle_tpu_torch import quantization as TQZ
from paddle_tpu_torch.optimizer import Adam

from test_torch_quantization import (  # noqa: F401 — shared helpers
    _close, _nets, cpu_rule)


def test_qat_trains_like_jax():
    jm, tm = _nets(0)
    jq = JQZ.FakeQuanterWithAbsMaxObserver(moving_rate=0.9)
    jqm = JQZ.QAT(JQZ.QuantConfig(activation=jq, weight=jq)).quantize(jm)
    tq = TQZ.FakeQuanterWithAbsMaxObserver(moving_rate=0.9)
    tqm = TQZ.QAT(TQZ.QuantConfig(activation=tq, weight=tq)).quantize(tm)
    assert isinstance(tqm[0], TQZ.QuantedLinear) and \
        isinstance(tqm[2], TQZ.QuantedLinear)
    assert tm[0].__class__ is torch.nn.Linear          # inplace=False copies
    jopt = paddle.optimizer.Adam(5e-3, parameters=jqm.parameters())
    topt = Adam(5e-3, parameters=tqm.parameters())
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 8)).astype(np.float32)
    y = rng.integers(0, 4, 16).astype(np.int64)
    ce = jnn.CrossEntropyLoss()
    jl, tl = [], []
    for _ in range(5):
        loss = ce(jqm(paddle.to_tensor(x)), paddle.to_tensor(y))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jl.append(float(loss))
        loss = torch.nn.functional.cross_entropy(
            tqm(torch.from_numpy(x)), torch.from_numpy(y))
        loss.backward()
        topt.step()
        topt.clear_grad()
        tl.append(float(loss.detach()))
        for i in ("0", "2"):
            for q in ("activation_quanter", "weight_quanter"):
                _close(getattr(tqm[int(i)], q).scales(),
                       getattr(jqm._sub_layers[i], q).scales(), 1e-5)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    deploy = TQZ.QAT(TQZ.QuantConfig()).convert(tqm)
    assert deploy[0].__class__ is torch.nn.Linear
    assert isinstance(tqm[0], TQZ.QuantedLinear)       # inplace=False
    # idempotent: a second quantize never nests
    again = TQZ.QAT(TQZ.QuantConfig(activation=tq, weight=tq)).quantize(tqm)
    assert not isinstance(again[0].inner, TQZ.QuantedLinear)
