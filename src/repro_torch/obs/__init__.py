"""Observability: tracing + metrics for the port (DESIGN.md §13).

Copies of the JAX package's jax-free ``obs`` modules, so the port's spans
and ``--trace-out`` / ``--metrics-out`` files have the reference's formats
without importing the reference package.
"""

from repro_torch.obs.clock import FakeClock, MonotonicClock
from repro_torch.obs.metrics import (SCHEMA_VERSION, Registry, get_registry,
                                     set_registry, validate_snapshot)
from repro_torch.obs.trace import (NULL_TRACER, NullTracer, Span, Tracer,
                                   current_tracer, set_tracer, use_tracer)

__all__ = [
    "FakeClock", "MonotonicClock",
    "SCHEMA_VERSION", "Registry", "get_registry", "set_registry",
    "validate_snapshot",
    "NULL_TRACER", "NullTracer", "Span", "Tracer",
    "current_tracer", "set_tracer", "use_tracer",
]
