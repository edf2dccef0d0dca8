"""Runtime telemetry of the port (counterpart of
``paddle_tpu/observability``): the metrics registry and its exporters,
the flight recorder, request tracing and the live telemetry server, each
the port's own copy (standard library only; nothing of the JAX package is
imported). The serving scheduler, page pool and engine record into them
under the JAX package's series names, span names and event kinds::

    import paddle_tpu_torch.observability as obs
    obs.serve(9406)   # /metrics /healthz /flight /requests /trace/<id>

Every switch is the JAX package's: ``PADDLE_TPU_METRICS=0``,
``PADDLE_TPU_FLIGHT=0`` and ``PADDLE_TPU_TRACE=0`` (or ``enable(False)``
on each module) leave one branch at each hook. Not ported: the memory
census, the step timer, the continuous profiler, the training health
tier, and the command-line tools.
"""

from . import continuous, flight, tracing
from .continuous import TelemetryServer, serve, shutdown_server
from .exporters import render_prometheus, snapshot
from .metrics import (DEFAULT_BUCKETS, Counter, Gauge, Histogram, Registry,
                      counter, enable, enabled, gauge, get_registry,
                      histogram, reset, total, value)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "DEFAULT_BUCKETS",
    "get_registry", "counter", "gauge", "histogram",
    "enabled", "enable", "value", "total", "reset",
    "render_prometheus", "snapshot", "dump", "serve_text", "flight",
    "tracing", "continuous", "serve", "shutdown_server", "TelemetryServer",
]


def dump(registry=None) -> dict:
    """JSON-safe snapshot of every sampled metric."""
    return snapshot(registry)


def serve_text(registry=None) -> str:
    """Prometheus text exposition of the registry."""
    return render_prometheus(registry)
