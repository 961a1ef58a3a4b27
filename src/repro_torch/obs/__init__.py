"""Observability: the metrics registry the trainer feeds (``repro_torch.obs.metrics``) and
the tracer's spans the gateway and workers open (``repro_torch.obs.trace``).

The reference's span sinks and run timelines (``repro.obs.sinks``,
``repro.obs.timeline``) wait for ROADMAP Queue 1 item 14.
"""

from .metrics import Counter, Gauge, Histogram, MetricsRegistry, reset_metrics
from .trace import Span, Tracer, extract_trace, get_tracer, inject_trace, strip_trace

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "reset_metrics",
    "Span",
    "Tracer",
    "extract_trace",
    "get_tracer",
    "inject_trace",
    "strip_trace",
]
