"""Distributed tracing: spans propagated as Ψ context facts, a copy of ``repro.obs.trace``.

The trace contract (docs/observability.md) in three invariants:

1. **Propagation is the context.** A span crossing a process boundary is
   carried as one reserved fact under :data:`TRACE_KEY` inside the same
   ``Context`` that already travels in every task submission — the worker
   transports (in-process and threaded HTTP) forward it untouched, so no
   wire format changes.
2. **Tracing never changes replay identity.** ``obs.``-prefixed facts are
   excluded from ``Context.digest()`` and injected with lamport 0, so a
   traced run commits byte-identical digests to an untraced one, and the
   fact is only stamped on the transient submit-time context — it is never
   stored into a node's output context.
3. **Replays are silent.** Call sites start spans only after the
   replay/cache probes miss; stages that turn out replayed call
   :meth:`Tracer.discard`. A replayed run therefore emits zero spans.

The tracer is a process-global singleton that is toggled, never replaced:
hot call sites cache ``get_tracer()`` once and guard with a single
``tracer.enabled`` attribute read, which is the entire disabled-mode cost.
"""

from __future__ import annotations

import threading
import time
import uuid
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Dict, Iterator, List, Optional, Tuple

if TYPE_CHECKING:  # context imports are deferred to call time: this module
    # is imported by repro_torch.core itself (gateway, server), so an eager
    # import here would re-enter repro_torch.core mid-initialization
    from repro_torch.core.context import Context

#: The reserved context key carrying trace identity across process hops
#: (under ``repro_torch.core.context.OBS_KEY_PREFIX``, the digest-excluded
#: namespace).
TRACE_KEY = "obs.trace"

#: Origin stamped on injected trace facts (never a worker identity).
TRACE_ORIGIN = "ψ.obs"


def _new_id() -> str:
    """A fresh 16-hex span/trace id."""
    return uuid.uuid4().hex[:16]


@dataclass
class Span:
    """One timed operation in a trace.

    ``start_wall`` is an epoch timestamp so spans correlate with journal
    record ``wall_time``; duration is measured on the monotonic clock
    (``_t0``) so it is immune to wall-clock steps.
    """

    name: str
    trace_id: str
    span_id: str
    parent_id: str = ""
    kind: str = "internal"  # run | node | rpc | task | stream | handoff | ...
    start_wall: float = 0.0
    dur_s: float = 0.0
    status: str = "ok"
    attrs: Dict[str, Any] = field(default_factory=dict)
    _t0: float = 0.0

    def to_obj(self) -> Dict[str, Any]:
        """The JSON-serializable wire/sink form of this span."""
        return {
            "name": self.name,
            "trace": self.trace_id,
            "span": self.span_id,
            "parent": self.parent_id,
            "kind": self.kind,
            "ts": self.start_wall,
            "dur": self.dur_s,
            "status": self.status,
            "attrs": dict(self.attrs),
        }


class Tracer:
    """Process-global span factory and sink fan-out.

    Disabled by default. Call sites hold the singleton (:func:`get_tracer`)
    and check :attr:`enabled` before building spans; :meth:`configure`
    mutates the flag and sink list in place so cached references stay
    valid. All sink emission happens at :meth:`end` time.
    """

    def __init__(self) -> None:
        self.enabled = False
        self._sinks: List[Any] = []
        self._lock = threading.Lock()
        self.discarded = 0  # spans started then dropped (replayed work)

    # -- lifecycle ----------------------------------------------------------
    def configure(self, *, enabled: Optional[bool] = None) -> None:
        """Toggle tracing; ``None`` leaves the flag unchanged."""
        if enabled is not None:
            self.enabled = bool(enabled)

    def add_sink(self, sink: Any) -> None:
        """Attach ``sink`` (any object with ``emit(span_obj)``)."""
        with self._lock:
            if sink not in self._sinks:
                self._sinks.append(sink)

    def remove_sink(self, sink: Any) -> None:
        """Detach ``sink``; unknown sinks are ignored."""
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)

    @contextmanager
    def attached(self, sink: Any, *, enable: bool = True) -> Iterator[Any]:
        """Attach ``sink`` (optionally enabling tracing) for a scope.

        Restores the previous enabled flag and detaches the sink on exit —
        the standard harness for tests.
        """
        prev = self.enabled
        self.add_sink(sink)
        if enable:
            self.enabled = True
        try:
            yield sink
        finally:
            self.enabled = prev
            self.remove_sink(sink)

    # -- span construction --------------------------------------------------
    def start_span(
        self,
        name: str,
        *,
        parent: Optional[Span] = None,
        trace_id: str = "",
        parent_id: str = "",
        kind: str = "internal",
        attrs: Optional[Dict[str, Any]] = None,
    ) -> Span:
        """Open a span. Parentage comes from ``parent`` or explicit ids.

        With neither, the span roots a brand-new trace.
        """
        if parent is not None:
            trace_id = parent.trace_id
            parent_id = parent.span_id
        return Span(
            name=name,
            trace_id=trace_id or _new_id(),
            span_id=_new_id(),
            parent_id=parent_id,
            kind=kind,
            start_wall=time.time(),  # record timestamp
            attrs=dict(attrs or {}),
            _t0=time.monotonic(),
        )

    def end(
        self,
        span: Span,
        *,
        status: str = "ok",
        attrs: Optional[Dict[str, Any]] = None,
    ) -> Span:
        """Close ``span`` and emit it to every attached sink."""
        span.dur_s = max(0.0, time.monotonic() - span._t0)
        span.status = status
        if attrs:
            span.attrs.update(attrs)
        obj = span.to_obj()
        with self._lock:
            sinks = list(self._sinks)
        for sink in sinks:
            try:
                sink.emit(obj)
            except Exception:  # a broken sink must never fail the run
                pass
        return span

    def discard(self, span: Span) -> None:
        """Drop a started span without emitting — the work was replayed."""
        self.discarded += 1

    @contextmanager
    def span(
        self,
        name: str,
        *,
        parent: Optional[Span] = None,
        trace_id: str = "",
        parent_id: str = "",
        kind: str = "internal",
        attrs: Optional[Dict[str, Any]] = None,
    ) -> Iterator[Optional[Span]]:
        """Context-managed span: ends ``ok`` on exit, ``error`` on raise.

        Yields ``None`` (and does nothing) when tracing is disabled.
        """
        if not self.enabled:
            yield None
            return
        sp = self.start_span(
            name, parent=parent, trace_id=trace_id, parent_id=parent_id, kind=kind, attrs=attrs
        )
        try:
            yield sp
        except BaseException:
            self.end(sp, status="error")
            raise
        self.end(sp)


_TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process-global singleton tracer (stable — cache it freely)."""
    return _TRACER


# -- context propagation ----------------------------------------------------


def inject_trace(ctx: "Context", span: Span) -> "Context":
    """Stamp ``span``'s identity onto ``ctx`` as a transient Ψ fact.

    The fact uses lamport 0 so ``ctx.max_lamport()`` — and therefore the
    lamport (and digest) of every later real fact — is identical between
    traced and untraced runs. Any previous trace fact is replaced, never
    accumulated. The returned context is for the wire only; callers keep
    threading the *original* ``ctx`` into commit/output paths.
    """
    from repro_torch.core.context import Context, ContextEntry

    entries = [e for e in ctx if e.key != TRACE_KEY]
    entries.append(
        ContextEntry.make(TRACE_KEY, {"t": span.trace_id, "s": span.span_id}, TRACE_ORIGIN, 0)
    )
    return Context(entries)


def extract_trace(ctx: "Context") -> Optional[Tuple[str, str]]:
    """Read ``(trace_id, parent_span_id)`` off ``ctx``, or ``None``."""
    raw = ctx.get(TRACE_KEY)
    if not isinstance(raw, dict):
        return None
    trace_id = str(raw.get("t", ""))
    span_id = str(raw.get("s", ""))
    if not trace_id or not span_id:
        return None
    return trace_id, span_id


def strip_trace(ctx: "Context") -> "Context":
    """Drop any trace fact from ``ctx`` (used before storing output ξ)."""
    from repro_torch.core.context import Context

    if ctx.get(TRACE_KEY) is None:
        return ctx
    return Context([e for e in ctx if e.key != TRACE_KEY])


__all__ = [
    "TRACE_KEY",
    "TRACE_ORIGIN",
    "Span",
    "Tracer",
    "extract_trace",
    "get_tracer",
    "inject_trace",
    "strip_trace",
]
