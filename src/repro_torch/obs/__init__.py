"""Observability of the port (DESIGN.md §12): span tracing + metrics."""
from .emit import Emitter
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
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
    "get_tracer",
    "trace_span",
    "tracing_enabled",
]
