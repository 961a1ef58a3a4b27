"""Observability: the metrics registry the trainer feeds (``repro_torch.obs.metrics``)."""

from .metrics import Counter, Gauge, Histogram, MetricsRegistry, reset_metrics

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "reset_metrics"]
