"""Observability of the port (DESIGN.md §12): span tracing + metrics.

``obs.characterize`` (imported explicitly: it pulls in ``core``) measures
the paper's per-stage execution on the live model."""
from .emit import Emitter
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    reset_registry,
)
from .trace import (
    Span,
    Tracer,
    disable_tracing,
    enable_tracing,
    get_tracer,
    trace_span,
    tracing_enabled,
)

__all__ = [
    "Counter",
    "Emitter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Span",
    "Tracer",
    "disable_tracing",
    "enable_tracing",
    "get_registry",
    "get_tracer",
    "reset_registry",
    "trace_span",
    "tracing_enabled",
]
