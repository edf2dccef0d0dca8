"""The live telemetry server (counterpart of
``paddle_tpu/observability/continuous``). The continuous profiler of the
JAX package is not ported; only its HTTP server is."""

from .server import (DEFAULT_PORT, DEFAULT_STALL_S, TelemetryServer,
                     register_health_provider, register_route, serve,
                     shutdown_server, unregister_route)

__all__ = ["TelemetryServer", "serve", "shutdown_server", "register_route",
           "unregister_route", "register_health_provider", "DEFAULT_PORT",
           "DEFAULT_STALL_S"]
