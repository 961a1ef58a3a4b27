"""Metrics: a copy of ``repro.obs.metrics``'s push instruments and registry.

:class:`Counter`, :class:`Gauge` and :class:`Histogram` are created through
:class:`MetricsRegistry`; call sites hold the instrument and update it
directly (a lock-guarded float add). The trainer feeds the process-global
registry (:func:`metrics`) with its ``repro_train_*`` gauges and counter,
under the reference's names.

Naming scheme (docs/observability.md): ``repro_<subsystem>_<what>[_total]``
with Prometheus-style ``{label="value"}`` suffixes baked into the name.
:meth:`MetricsRegistry.to_prometheus` renders text exposition format and
:meth:`MetricsRegistry.to_json` a stable JSON document. The reference's pull
collectors (gateway, channel and result-cache stats) are not copied: the
port has none of those objects yet.
"""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Mapping, Tuple

#: Default histogram bucket upper bounds, in seconds (latency-oriented).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001,
    0.005,
    0.01,
    0.05,
    0.1,
    0.5,
    1.0,
    5.0,
    10.0,
    30.0,
    60.0,
)


def _labeled(name: str, labels: Mapping[str, str]) -> str:
    """Render ``name{k="v",...}`` with labels sorted for determinism."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """A monotonically increasing float (use ``*_total`` names)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        """Add ``n`` (must be >= 0) to the counter."""
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        """Current cumulative value."""
        return self._value


class Gauge:
    """A point-in-time float that can go up and down."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        """Replace the gauge's value."""
        with self._lock:
            self._value = float(v)

    def add(self, n: float) -> None:
        """Adjust the gauge by ``n`` (negative to decrement)."""
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        """Current value."""
        return self._value


class Histogram:
    """Bucketed distribution of observations (Prometheus-compatible)."""

    __slots__ = ("name", "buckets", "_counts", "_sum", "_count", "_lock")

    def __init__(self, name: str, buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        self.name = name
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # +inf tail bucket
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        """Record one observation."""
        idx = len(self.buckets)
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                idx = i
                break
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1

    @contextmanager
    def time(self) -> Iterator[None]:
        """Observe the monotonic duration of the ``with`` body."""
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.observe(time.monotonic() - t0)

    def snapshot(self) -> Dict[str, Any]:
        """Cumulative bucket counts plus sum/count."""
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        cum: Dict[str, int] = {}
        acc = 0
        for ub, c in zip(self.buckets, counts, strict=False):  # counts has a +Inf slot
            acc += c
            cum[repr(ub)] = acc
        cum["+Inf"] = total
        return {"buckets": cum, "sum": s, "count": total}


class MetricsRegistry:
    """Instrument factory behind one snapshot API."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    # -- instruments --------------------------------------------------------
    def counter(self, name: str, **labels: str) -> Counter:
        """Get or create the counter ``name`` (labels baked into the name)."""
        key = _labeled(name, labels)
        with self._lock:
            inst = self._counters.get(key)
            if inst is None:
                inst = self._counters[key] = Counter(key)
        return inst

    def gauge(self, name: str, **labels: str) -> Gauge:
        """Get or create the gauge ``name``."""
        key = _labeled(name, labels)
        with self._lock:
            inst = self._gauges.get(key)
            if inst is None:
                inst = self._gauges[key] = Gauge(key)
        return inst

    def histogram(
        self, name: str, buckets: Tuple[float, ...] = DEFAULT_BUCKETS, **labels: str
    ) -> Histogram:
        """Get or create the histogram ``name``."""
        key = _labeled(name, labels)
        with self._lock:
            inst = self._histograms.get(key)
            if inst is None:
                inst = self._histograms[key] = Histogram(key, buckets)
        return inst

    @contextmanager
    def timer(self, name: str, **labels: str) -> Iterator[None]:
        """Shorthand: time the ``with`` body into histogram ``name``."""
        with self.histogram(name, **labels).time():
            yield

    # -- export -------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """One flat view: counters, gauges, histograms."""
        with self._lock:
            counters = {k: c.value for k, c in self._counters.items()}
            gauges = {k: g.value for k, g in self._gauges.items()}
            hists = {k: h.snapshot() for k, h in self._histograms.items()}
        return {"counters": counters, "gauges": gauges, "histograms": hists}

    def to_json(self) -> str:
        """The snapshot as a stable (sorted-keys) JSON document."""
        return json.dumps(self.snapshot(), sort_keys=True)

    def to_prometheus(self) -> str:
        """The snapshot in Prometheus text exposition format."""
        snap = self.snapshot()
        lines: List[str] = []
        for name in sorted(snap["counters"]):
            lines.append(f"{name} {_fmt(snap['counters'][name])}")
        for name in sorted(snap["gauges"]):
            lines.append(f"{name} {_fmt(snap['gauges'][name])}")
        for name in sorted(snap["histograms"]):
            h = snap["histograms"][name]
            base, labels = _split_labels(name)
            for ub, c in h["buckets"].items():
                le = ",".join(filter(None, [labels, f'le="{ub}"']))
                lines.append(f"{base}_bucket{{{le}}} {c}")
            suffix = f"{{{labels}}}" if labels else ""
            lines.append(f"{base}_sum{suffix} {_fmt(h['sum'])}")
            lines.append(f"{base}_count{suffix} {h['count']}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Drop every instrument (test isolation)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


def _fmt(v: float) -> str:
    """Integers render bare; floats keep their repr."""
    return str(int(v)) if float(v).is_integer() else repr(float(v))


def _split_labels(key: str) -> Tuple[str, str]:
    """Split ``name{a="b"}`` into (``name``, ``a="b"``)."""
    if "{" not in key:
        return key, ""
    base, _, rest = key.partition("{")
    return base, rest.rstrip("}")


_REGISTRY = MetricsRegistry()


def metrics() -> MetricsRegistry:
    """The process-global registry (stable singleton — cache it freely)."""
    return _REGISTRY


def reset_metrics() -> None:
    """Clear the global registry (test isolation helper)."""
    _REGISTRY.reset()


__all__ = [
    "DEFAULT_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "metrics",
    "reset_metrics",
]
