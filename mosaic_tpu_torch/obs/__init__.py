"""Observability layer of the port: hierarchical spans over the
telemetry spine (``obs/trace.py``; importing it registers the tracer).
Metrics, the flight recorder and the timeline are later slices."""

from . import trace
from .trace import SpanContext, adopt_context, current_context, span, start_span

__all__ = [
    "SpanContext",
    "adopt_context",
    "current_context",
    "span",
    "start_span",
    "trace",
]
