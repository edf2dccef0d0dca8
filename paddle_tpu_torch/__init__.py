"""paddle_tpu_torch: the PyTorch and CUDA port of paddle_tpu.

It mirrors the JAX package's layout (``ops/kernels``, ``nn``, ``models``,
``serving``) so each module's counterpart is found under the same path.
Plain tensor code is PyTorch; every TPU kernel on a ported path is a
hand-written CUDA kernel for Hopper (``csrc/``), built at first use. The
package imports neither JAX nor ``paddle_tpu``.

It serves Llama through :class:`paddle_tpu_torch.serving.LLMEngine`
(float or weight-only quantized); ``nn.quant`` holds the quantized linear
functions. It trains Llama and GPT-2 through the backward kernels, with
every optimizer of ``paddle_tpu_torch.optimizer`` (AdamW and Lamb through
their kernels), its learning-rate schedulers (``optimizer.lr``),
``regularizer`` and ``nn.clip``, and the loss of
``distributed.ParallelCrossEntropy`` through the cross-entropy kernel.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
__version__ = "0.1.0"
