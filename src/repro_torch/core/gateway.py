"""Gateway (§3.3): the central authoritative scheduler, a copy of ``repro.core.gateway``.

The gateway stores the context for its servers, queues tasks (single-level
queue or a priority "queue silo"), and picks the optimal worker with an
allocation algorithm. Allocation must be fast — the paper warns (§5) that
gateway bottlenecks magnify at scale — so every built-in algorithm is O(1)
or O(log n) per decision, and decisions use *cached* heartbeat telemetry
refreshed by a background poller rather than a synchronous probe per task.

Fallback chain: if an algorithm raises or returns no worker, the next one in
the chain is consulted; the terminal fallback is round-robin over live
workers — graceful degradation, never a hard stop from the scheduler itself.

The one departure from the reference: its asyncio runtime
(``REPRO_RUNTIME=async``, ``repro.core.aio``) is not copied yet, and
``Gateway(...)`` refuses it by name (ROADMAP Queue 1 item 15) rather than
quietly building the threaded gateway.
"""

from __future__ import annotations

import heapq
import itertools
import os
import random
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.obs.trace import extract_trace, get_tracer
from repro_torch.wire import PayloadDecodeError, unwrap_digested

from .context import Context, EMPTY_CONTEXT
from .durable import Interrupted

__all__ = [
    "TaskRequest",
    "WorkerHandle",
    "AllocationError",
    "TaskCancelled",
    "Gateway",
    "round_robin",
    "least_loaded",
    "power_of_two",
    "context_affinity",
]


class AllocationError(RuntimeError):
    """No worker could (ever) take the request — retries/backoffs exhausted."""


class TaskCancelled(RuntimeError):
    """A queued request was withdrawn by ``cancel_run`` before dispatch.

    Benign by contract: the submitting executor treats it as "this node
    returns to the pending frontier", never as a task failure.
    """


@dataclass
class TaskRequest:
    """One queued unit of work: task name, context, inputs, routing hints."""

    task_name: str
    ctx: Context = EMPTY_CONTEXT
    inputs: Mapping[str, Any] = field(default_factory=dict)
    priority: int = 0  # lower = more urgent (silo key)
    affinity_key: str = ""  # context-affinity routing hint
    future: Future = field(default_factory=Future)
    submitted_at: float = field(default_factory=time.time)
    attempts: int = 0  # failure budget: real execution failures/evictions
    backoffs: int = 0  # empty-pool waits — NOT charged to the budget
    max_attempts: int = 3
    meta: Dict[str, Any] = field(default_factory=dict)  # caller attribution
    last_error: Optional[BaseException] = None  # surfaced if backoffs exhaust


@dataclass
class WorkerHandle:
    """Gateway-side view of a Server: transport + cached telemetry (context)."""

    worker: Any  # InProcWorker | WorkerClient surface
    name: str
    live: bool = True  # heartbeat verdict (system level)
    app_live: bool = True  # application verdict
    telemetry: Optional[Dict[str, Any]] = None
    last_seen: float = 0.0  # monotonic stamp of the last successful probe
    inflight: int = 0
    completed: int = 0
    ewma_latency_s: float = 0.0  # straggler detection input (monotonic deltas)
    held_contexts: set = field(default_factory=set)  # affinity state
    hb_misses: int = 0  # consecutive failed heartbeat probes
    app_quarantined_until: float = 0.0  # monotonic deadline for app_live self-heal
    inflight_reqs: Dict[int, "TaskRequest"] = field(default_factory=dict)
    # ^ id(req) → req for every request currently running on this worker;
    #   the eviction path drains it to requeue orphans on survivors.

    def load_score(self) -> float:
        """Cheap load proxy: inflight + reported cpu usage."""
        cpu = 0.0
        if self.telemetry:
            cpu = float(self.telemetry.get("cpu", {}).get("used_frac", 0.0))
        return self.inflight + cpu


# --------------------------------------------------------------------------
# allocation algorithms (pluggable, §3.3 assumption 3)
# --------------------------------------------------------------------------


def round_robin(
    workers: Sequence[WorkerHandle], req: TaskRequest, state: Dict[str, Any]
) -> Optional[WorkerHandle]:
    """Cycle over live workers — the terminal graceful-degradation fallback."""
    live = [w for w in workers if w.live and w.app_live]
    if not live:
        return None
    i = state.setdefault("rr", itertools.count())
    return live[next(i) % len(live)]


def least_loaded(
    workers: Sequence[WorkerHandle], req: TaskRequest, state: Dict[str, Any]
) -> Optional[WorkerHandle]:
    """Pick the live worker with the lowest (inflight + cpu) load score."""
    live = [w for w in workers if w.live and w.app_live]
    if not live:
        return None
    return min(live, key=lambda w: (w.load_score(), w.name))


def power_of_two(
    workers: Sequence[WorkerHandle], req: TaskRequest, state: Dict[str, Any]
) -> Optional[WorkerHandle]:
    """Power-of-two-choices: O(1) with near-least-loaded quality."""
    live = [w for w in workers if w.live and w.app_live]
    if not live:
        return None
    rng: random.Random = state.setdefault("rng", random.Random(0))
    a, b = rng.choice(live), rng.choice(live)
    return min((a, b), key=lambda w: (w.load_score(), w.name))


def context_affinity(
    workers: Sequence[WorkerHandle], req: TaskRequest, state: Dict[str, Any]
) -> Optional[WorkerHandle]:
    """Prefer the worker already holding the task's context (sharded state)."""
    if not req.affinity_key:
        return None  # fall through the chain
    live = [w for w in workers if w.live and w.app_live]
    holders = [w for w in live if req.affinity_key in w.held_contexts]
    if holders:
        return min(holders, key=lambda w: (w.load_score(), w.name))
    return None


_ALGOS: Dict[str, Callable] = {
    "round_robin": round_robin,
    "least_loaded": least_loaded,
    "power_of_two": power_of_two,
    "context_affinity": context_affinity,
}


class Gateway:
    """Central task router with queue/queue-silo + allocation fallback chain.

    The reference has two runtimes behind this class: the thread-per-request
    one implemented here, and an asyncio one that ``REPRO_RUNTIME=async``
    selects. The port has only the first; it refuses the second by name.
    """

    def __new__(cls, *args, **kw):
        """Refuse ``REPRO_RUNTIME=async``: the asyncio runtime is not ported yet."""
        if cls is Gateway and os.environ.get("REPRO_RUNTIME", "").lower() == "async":
            raise NotImplementedError(
                "REPRO_RUNTIME=async: the asyncio gateway runtime (AsyncGateway, "
                "AsyncWorkerServer, AsyncWorkerClient, ShardedGateway) is not ported yet: "
                "ROADMAP Queue 1 item 15"
            )
        return super().__new__(cls)

    def __init__(
        self,
        workers: Sequence[Any],
        *,
        allocation: Sequence[str] = ("context_affinity", "least_loaded"),
        silo: bool = False,
        heartbeat_interval_s: float = 0.5,
        dispatch_threads: int = 8,
        evict_after_misses: int = 2,
        quarantine_s: float = 2.0,
        name: str = "gateway",
    ):
        self.name = name
        self.handles: List[WorkerHandle] = [
            WorkerHandle(worker=w, name=getattr(w, "name", f"w{i}"))
            for i, w in enumerate(workers)
        ]
        chain = [(_ALGOS[a] if isinstance(a, str) else a) for a in allocation]
        if round_robin not in chain:
            chain.append(round_robin)  # terminal graceful-degradation fallback
        self.allocation_chain = chain
        self._alloc_state: Dict[str, Any] = {}
        self.silo = silo
        self._queue: deque = deque()
        self._silo: List[Tuple[int, int, TaskRequest]] = []  # heap
        self._silo_counter = itertools.count()
        self._cv = threading.Condition()
        self._stop = threading.Event()
        self._hb_interval = heartbeat_interval_s
        self.evict_after_misses = evict_after_misses
        self.quarantine_s = quarantine_s
        self._threads: List[threading.Thread] = []
        self._dispatch_threads = dispatch_threads
        self._track_lock = threading.Lock()  # guards inflight counters/registries
        self.on_worker_down: Optional[Callable[[WorkerHandle], None]] = None
        self.on_requeue: Optional[Callable[[TaskRequest, str], None]] = None
        self.metrics = {
            "scheduled": 0,
            "rejected": 0,
            "requeued": 0,
            "evicted": 0,
            "corrupt": 0,
            "cancelled": 0,
            "alloc_ns_total": 0,
            "alloc_calls": 0,
        }
        self.suspended_runs: Dict[str, Dict[str, Any]] = {}  # run token → info
        self.crashed = False  # set by crash() — fault injection, not shutdown

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "Gateway":
        """Start heartbeat + dispatch threads; probe workers once, synchronously."""
        hb = threading.Thread(target=self._heartbeat_loop, name=f"{self.name}:hb", daemon=True)
        hb.start()
        self._threads.append(hb)
        for i in range(self._dispatch_threads):
            t = threading.Thread(
                target=self._dispatch_loop, name=f"{self.name}:dispatch{i}", daemon=True
            )
            t.start()
            self._threads.append(t)
        self._refresh_heartbeats()  # synchronous first pass: start with fresh context
        return self

    def stop(self) -> None:
        """Signal every gateway thread to exit and join them (bounded wait)."""
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=2)

    def crash(self) -> None:
        """Sudden-death simulation: halt dispatch/heartbeats WITHOUT draining.

        Unlike :meth:`stop` this is fault injection, not shutdown — queued
        requests stay unresolved and in-flight futures are left dangling,
        exactly as if the gateway process died. The reference's
        ``ShardedGateway`` (ROADMAP Queue 1 item 15) reads the ``crashed``
        flag to hand the replica's partition to a survivor.
        """
        self.crashed = True
        self.stop()

    def __enter__(self) -> "Gateway":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- submission ------------------------------------------------------------
    def submit(
        self,
        task_name: str,
        ctx: Context = EMPTY_CONTEXT,
        inputs: Optional[Mapping[str, Any]] = None,
        *,
        priority: int = 0,
        affinity_key: str = "",
        max_attempts: int = 3,
        meta: Optional[Mapping[str, Any]] = None,
    ) -> Future:
        """Enqueue one task for dispatch; returns the Future of its result.

        A streaming task (the worker's function is a generator) resolves its
        Future with a live chunk *iterator* instead of a value — see
        docs/streaming.md §5.

        ``Digested`` input wrappers (precomputed-digest hints from the
        executor's tensor path) are stripped here: workers and transports
        always see plain payload values.
        """
        req = TaskRequest(
            task_name=task_name,
            ctx=ctx,
            inputs=unwrap_digested(dict(inputs or {})),
            priority=priority,
            affinity_key=affinity_key,
            max_attempts=max_attempts,
            meta=dict(meta or {}),
        )
        with self._cv:
            if self.silo:
                heapq.heappush(self._silo, (priority, next(self._silo_counter), req))
            else:
                self._queue.append(req)
            self._cv.notify()
        return req.future

    def map(
        self,
        task_name: str,
        inputs_list: Sequence[Mapping[str, Any]],
        ctx: Context = EMPTY_CONTEXT,
        **kw,
    ) -> List[Future]:
        """Submit one task per input mapping; returns the Futures in order."""
        return [self.submit(task_name, ctx, inp, **kw) for inp in inputs_list]

    # -- run-level control (suspension) ---------------------------------------
    def cancel_run(self, run_token: str) -> int:
        """Withdraw every still-QUEUED request whose ``meta["run"]`` matches.

        Requests already handed to a worker are left to finish (a suspend is
        a clean drain, not an abort). Each withdrawn future fails with
        :class:`TaskCancelled`; returns the number withdrawn.
        """
        cancelled: List[TaskRequest] = []
        with self._cv:
            kept = deque()
            while self._queue:
                req = self._queue.popleft()
                (cancelled if req.meta.get("run") == run_token else kept).append(req)
            self._queue = kept
            kept_silo = []
            for entry in self._silo:
                if entry[2].meta.get("run") == run_token:
                    cancelled.append(entry[2])
                else:
                    kept_silo.append(entry)
            heapq.heapify(kept_silo)
            self._silo = kept_silo
        for req in cancelled:
            self.metrics["cancelled"] += 1
            self._fail(req, TaskCancelled(f"run {run_token} suspended"))
        return len(cancelled)

    def mark_suspended(self, run_token: str, interrupt: str) -> None:
        """Book a run as suspended at a named interrupt (shows up in stats())."""
        with self._track_lock:
            self.suspended_runs[run_token] = {
                "interrupt": interrupt,
                "since": time.time(),  # record timestamp
            }

    # -- internals ------------------------------------------------------------
    def _pop(self, timeout: float = 0.1) -> Optional[TaskRequest]:
        with self._cv:
            if not self._queue and not self._silo:
                self._cv.wait(timeout)
            if self.silo and self._silo:
                return heapq.heappop(self._silo)[2]
            if self._queue:
                return self._queue.popleft()
        return None

    def _allocate(self, req: TaskRequest) -> Optional[WorkerHandle]:
        t0 = time.perf_counter_ns()
        try:
            for algo in self.allocation_chain:
                try:
                    w = algo(self.handles, req, self._alloc_state)
                except Exception:
                    continue  # fallback on algorithm failure (§3.3)
                if w is not None:
                    return w
            return None
        finally:
            self.metrics["alloc_ns_total"] += time.perf_counter_ns() - t0
            self.metrics["alloc_calls"] += 1

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            req = self._pop()
            if req is None:
                continue
            handle = self._allocate(req)
            if handle is None:
                # no live workers: retry later rather than dropping (degrade).
                # Queue-waiting is not a task failure: it burns the separate
                # backoff budget, never req.attempts.
                time.sleep(0.05)
                req.backoffs += 1
                if req.backoffs >= req.max_attempts * 4:
                    # surface the request's own last failure (e.g. a typed
                    # PayloadDecodeError that quarantined every worker)
                    # rather than a generic allocation error
                    self._fail(
                        req,
                        req.last_error or AllocationError("no live workers available"),
                    )
                    self.metrics["rejected"] += 1
                else:
                    self._resubmit(req, "no live workers (backoff)", notify=False)
                continue
            self._run_on(handle, req)

    def _resubmit(self, req: TaskRequest, reason: str = "", *, notify: bool = True) -> None:
        with self._cv:
            if self.silo:
                heapq.heappush(self._silo, (req.priority, next(self._silo_counter), req))
            else:
                self._queue.append(req)
            self._cv.notify()
        self.metrics["requeued"] += 1
        if notify and self.on_requeue is not None:
            try:
                self.on_requeue(req, reason)
            except Exception:
                pass  # observer errors must not take down dispatch

    @staticmethod
    def _fail(req: TaskRequest, exc: BaseException) -> None:
        # a dispatch thread and the heartbeat eviction path may race to
        # resolve the same future; losing that race is benign (first wins)
        try:
            if not req.future.done():
                req.future.set_exception(exc)
        except InvalidStateError:
            pass

    @staticmethod
    def _resolve(req: TaskRequest, value: Any) -> None:
        try:
            if not req.future.done():  # speculative duplicates race benignly
                req.future.set_result(value)
        except InvalidStateError:
            pass

    def _release(self, handle: WorkerHandle, req: TaskRequest) -> bool:
        """Unregister a returned request; False ⇒ eviction already requeued it."""
        with self._track_lock:
            handle.inflight = max(0, handle.inflight - 1)
            return handle.inflight_reqs.pop(id(req), None) is not None

    def _evict(self, handle: WorkerHandle, reason: str) -> None:
        """Requeue every in-flight request of a dead worker on survivors.

        Consumes the heartbeat verdict: called when the monitor (or a
        system-level transport error) declares the worker dead. Orphaned
        requests are re-enqueued with their attempt count bumped; callers
        that registered ``on_requeue`` (the ClusterExecutor) journal each
        one. Idempotent — a request is drained exactly once.
        """
        with self._track_lock:
            orphans = list(handle.inflight_reqs.values())
            handle.inflight_reqs.clear()
        for req in orphans:
            if req.future.done():
                continue
            req.attempts += 1
            self.metrics["evicted"] += 1
            if req.attempts >= req.max_attempts:
                self._fail(
                    req,
                    AllocationError(
                        f"task {req.task_name} lost with evicted worker {handle.name}"
                    ),
                )
            else:
                self._resubmit(req, f"{reason}: evicted from {handle.name}")

    def _rpc_span(self, handle: WorkerHandle, req: TaskRequest):
        """Open the gateway→worker rpc span for ``req``, or None when off.

        Parent identity is read from the obs fact riding ``req.ctx`` — the
        same context that crosses the wire — so the span chain survives
        resubmission, speculation copies, and sharded-gateway handoffs.
        """
        tracer = get_tracer()
        if not tracer.enabled:
            return None
        parent = extract_trace(req.ctx)
        return tracer.start_span(
            f"rpc:{req.task_name}",
            trace_id=parent[0] if parent else "",
            parent_id=parent[1] if parent else "",
            kind="rpc",
            attrs={
                "worker": handle.name,
                "task": req.task_name,
                "node": str(req.meta.get("node", "")),
                "attempt": req.attempts,
            },
        )

    def _run_on(self, handle: WorkerHandle, req: TaskRequest) -> None:
        with self._track_lock:
            handle.inflight += 1
            handle.inflight_reqs[id(req)] = req
        span = self._rpc_span(handle, req)
        t0 = time.monotonic()  # interval math must survive wall-clock steps
        try:
            result = handle.worker.run_task(req.task_name, req.ctx, req.inputs)
        except (ConnectionError, TimeoutError, PayloadDecodeError) as exc:
            if span is not None:
                get_tracer().end(span, status="error", attrs={"error": type(exc).__name__})
            self._on_invoke_error(handle, req, exc)
            return
        if span is not None:
            get_tracer().end(span, status=str(result.get("status", "ok")))
        self._on_result(handle, req, result, time.monotonic() - t0)

    def _on_invoke_error(
        self, handle: WorkerHandle, req: TaskRequest, exc: BaseException
    ) -> None:
        """The failure taxonomy of a worker invocation (shared with the asyncio runtime
        in the reference).

        ``ConnectionError`` is a system-level failure: mark dead, requeue
        elsewhere. Siblings still executing on the handle are NOT evicted
        here — in-flight calls may yet succeed, and the heartbeat path
        (consecutive misses) recovers the truly-stuck ones without
        double-running the healthy ones. ``TimeoutError`` and
        ``PayloadDecodeError`` are application-level: heartbeat may still be
        fine, so the worker is quarantined rather than declared dead, and
        the request retries on a healthy worker with its typed last_error
        preserved.
        """
        if isinstance(exc, ConnectionError):
            owned = self._release(handle, req)
            with self._track_lock:
                was_live, handle.live = handle.live, False
            if was_live and self.on_worker_down:  # once per death, not per call
                self.on_worker_down(handle)
            if not owned:
                return  # heartbeat eviction already requeued this request
            req.attempts += 1
            if req.attempts >= req.max_attempts:
                self._fail(
                    req,
                    AllocationError(
                        f"task {req.task_name} exhausted retries (system failures)"
                    ),
                )
            else:
                self._resubmit(req, f"system failure on {handle.name}")
            return
        owned = self._release(handle, req)
        handle.app_live = False
        handle.app_quarantined_until = time.monotonic() + self.quarantine_s
        req.last_error = exc
        corrupt = isinstance(exc, PayloadDecodeError)
        if corrupt:
            self.metrics["corrupt"] += 1
        if not owned:
            return
        req.attempts += 1
        if req.attempts >= req.max_attempts:
            self._fail(req, exc)
        elif corrupt:
            self._resubmit(req, f"corrupt payload from {handle.name}")
        else:
            self._resubmit(req, f"application failure on {handle.name}")

    def _on_result(
        self, handle: WorkerHandle, req: TaskRequest, result: Mapping[str, Any], dt: float
    ) -> None:
        """Status-dict handling for a completed invocation (shared with the asyncio
        runtime in the reference)."""
        owned = self._release(handle, req)
        handle.completed += 1
        handle.ewma_latency_s = (
            0.8 * handle.ewma_latency_s + 0.2 * dt if handle.ewma_latency_s else dt
        )
        if req.affinity_key:
            handle.held_contexts.add(req.affinity_key)
        self.metrics["scheduled"] += 1
        status = result.get("status")
        if status == "ok":
            self._resolve(req, result["output"])
        elif status == "stream":
            # a stream-source task: the future resolves with the live chunk
            # iterator (chunk framing happens in the worker transport); the
            # consumer drives it and handles mid-stream failures by
            # re-dispatching from its last durable offset (streaming.md §5)
            self._resolve(req, result["stream"])
        elif status == "interrupt":
            # the task reached a named interrupt point: surface the typed
            # suspension request to the submitter — never retried, never
            # charged to the failure budget
            if not owned:
                return
            self._fail(
                req,
                Interrupted(str(result.get("name", "")), result.get("payload")),
            )
        elif status == "rejected":
            if not owned:
                return  # a requeued copy owns the outcome now
            self._fail(req, PermissionError(result.get("reason", "rejected")))
            self.metrics["rejected"] += 1
        else:
            if not owned:
                return  # already requeued by eviction; don't double-count
            req.attempts += 1
            if req.attempts >= req.max_attempts:
                self._fail(req, RuntimeError(result.get("error", "task failed")))
            else:
                self._resubmit(req, f"application error on {handle.name}")

    def _apply_probe(self, h: WorkerHandle, tel: Optional[Dict[str, Any]]) -> None:
        """Apply one heartbeat verdict to a handle.

        Liveness transition, telemetry/last_seen/miss bookkeeping, app-level
        self-heal, the once-per-death ``on_worker_down`` edge, and the
        consecutive-miss eviction threshold all live here (the reference's
        asyncio prober shares this state machine).
        """
        with self._track_lock:  # transition must be atomic vs _run_on's
            was_live, h.live = h.live, tel is not None
        h.telemetry = tel
        # monotonic, not wall: last_seen feeds liveness-age math and must
        # not jump under NTP steps (clock policy, docs/static-analysis.md)
        h.last_seen = time.monotonic() if tel else h.last_seen
        h.hb_misses = 0 if tel is not None else h.hb_misses + 1
        if tel is not None:
            reported = getattr(h.worker, "app_alive", None)
            if reported is not None:
                h.app_live = reported  # the worker self-reports: trust it
            elif time.monotonic() >= h.app_quarantined_until:
                # workers without a self-report (HTTP transports) only
                # self-heal after the quarantine window — a corrupt-but-
                # alive worker must not re-enter rotation every probe
                h.app_live = True
        if was_live and not h.live and self.on_worker_down:
            self.on_worker_down(h)
        if not h.live and h.inflight_reqs and h.hb_misses >= self.evict_after_misses:
            # the heartbeat verdict drives recovery, not just routing —
            # but a single missed probe is routing-only (self-heals on the
            # next probe); eviction needs consecutive misses so one GC
            # pause or network blip can't charge the task failure budget
            self._evict(h, "heartbeat lost")

    def _refresh_heartbeats(self) -> None:
        for h in self.handles:
            tel = None
            t0 = time.perf_counter()
            try:
                tel = h.worker.heartbeat()
            except Exception:
                tel = None
            if tel is not None:
                # HTTP probes stamp their own RTT (check_heartbeat); stamp
                # in-proc workers with the gateway-measured probe time so
                # stats() always carries a probe_latency_s signal
                tel.setdefault("probe_latency_s", time.perf_counter() - t0)
            self._apply_probe(h, tel)

    def _heartbeat_loop(self) -> None:
        while not self._stop.is_set():
            self._refresh_heartbeats()
            self._stop.wait(self._hb_interval)

    # -- introspection ----------------------------------------------------------
    def cluster_context(self) -> Context:
        """The gateway 'stores the context required for the associated Servers'."""
        facts = {}
        for h in self.handles:
            facts[f"worker/{h.name}/live"] = h.live
            facts[f"worker/{h.name}/app_live"] = h.app_live
            facts[f"worker/{h.name}/completed"] = h.completed
            if h.telemetry:
                facts[f"worker/{h.name}/cpu"] = h.telemetry["cpu"]["used_frac"]
        return Context.origin(facts, origin=self.name)

    def live_workers(self) -> List[WorkerHandle]:
        """Workers currently passing both system and application liveness."""
        return [h for h in self.handles if h.live and h.app_live]

    def stats(self) -> Dict[str, Any]:
        """One coherent telemetry snapshot of the whole gateway.

        Per-worker liveness, inflight/completed counts, EWMA task latency,
        the last heartbeat's ``probe_latency_s``, plus queue/silo depths and
        the dispatch metrics — the inputs a stream-aware allocator needs
        (route a chunk stream to the worker with headroom AND a fast probe).
        """
        with self._cv:
            queue_depth = len(self._queue)
            silo_depth = len(self._silo)
        workers: Dict[str, Dict[str, Any]] = {}
        with self._track_lock:
            for h in self.handles:
                tel = h.telemetry or {}
                workers[h.name] = {
                    "live": h.live,
                    "app_live": h.app_live,
                    "inflight": h.inflight,
                    "completed": h.completed,
                    "hb_misses": h.hb_misses,
                    "ewma_latency_s": h.ewma_latency_s,
                    "probe_latency_s": float(tel.get("probe_latency_s", 0.0)),
                    # age, not a wall timestamp: last_seen is monotonic
                    "last_seen_age_s": (
                        max(0.0, time.monotonic() - h.last_seen) if h.last_seen else -1.0
                    ),
                    "held_contexts": len(h.held_contexts),
                }
        with self._track_lock:
            suspended = {k: dict(v) for k, v in self.suspended_runs.items()}
        return {
            "workers": workers,
            "queue_depth": queue_depth,
            "silo_depth": silo_depth,
            "suspended_runs": suspended,
            "live_workers": sum(1 for w in workers.values() if w["live"] and w["app_live"]),
            "metrics": dict(self.metrics),
            "mean_alloc_us": self.mean_alloc_us(),
        }

    def mean_alloc_us(self) -> float:
        """Mean allocation-decision latency in microseconds (§5 bottleneck gauge)."""
        calls = max(1, self.metrics["alloc_calls"])
        return self.metrics["alloc_ns_total"] / calls / 1e3
