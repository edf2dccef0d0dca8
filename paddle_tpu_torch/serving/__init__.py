"""Continuous-batching LLM serving over a paged KV cache (counterpart of
``paddle_tpu/serving``). The default ``ServingConfig()`` is the JAX
engine's: monolithic prefill through the flash-attention kernel, the
block-epilogue kernels at every residual junction, and the prefix cache
with copy-on-write page sharing; chunked prefill and the per-op path are
options, and so is speculative decoding (``spec_k``: n-gram drafts
verified over K + 1 lanes a row by the decode-attention kernel). Decode
attention, RMSNorm, RoPE and SwiGLU are the port's kernels too.
``server`` mounts an engine on the telemetry server (``POST /generate``);
the scheduler, pool and engine record the JAX package's
``paddle_tpu_serving_*`` series, request traces and flight events
(``paddle_tpu_torch.observability``)."""

from .engine import LLMEngine, ServingConfig
from .kv_cache import (PageDoubleFree, PagePool, PagePoolError,
                       PagePoolExhausted)
from .model import ServingModel
from .prefix_cache import PrefixCache, chain_keys, model_fingerprint
from .scheduler import Request, RequestRejected, Scheduler, ServingError
from .speculative import NgramDrafter, SpecState, verify_tokens
from . import server  # noqa: E402 — after the engine it serves

__all__ = ["LLMEngine", "ServingConfig", "ServingModel", "PagePool",
           "PagePoolError", "PagePoolExhausted", "PageDoubleFree",
           "PrefixCache", "chain_keys", "model_fingerprint", "Request",
           "RequestRejected", "Scheduler", "ServingError", "NgramDrafter",
           "SpecState", "verify_tokens", "server"]
