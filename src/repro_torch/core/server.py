"""Server (§3.2): the generic, weakly-opinionated compute worker, a copy of
``repro.core.server``.

A ``WorkerServer`` owns a registry of atomic tasks (every mapping is a function
that gets all its dependencies through DI) and executes requests either over a
real HTTP transport or in-process. Middleware hooks (auth, validation,
instrumentation) are pluggable, matching the paper's "users can extend it with
security check pipelines, authentication and authorization mechanisms".

The heartbeat endpoint is ALWAYS a separate server on a separate port
(assumption 1 of §3.2), so a crashed application leaves the heartbeat alive —
that asymmetry is what the failure detector reads.

A registry task that returns a *generator* is a streaming task: over HTTP
its chunks cross the wire incrementally as crc-checked frames in a chunked
response body (docs/streaming.md §5); in-process the generator itself is
handed to the caller. Either way the consumer sees chunks as they are
produced, never a materialized batch.

In the reference this module is also the semantic layer of an asyncio
worker transport (``repro.core.aio.server``), which reuses ``_execute`` and
``_stream_values``; the port's copy of that runtime is ROADMAP Queue 1
item 15. Over HTTP the port uses only its own ``wire`` (msgpack by its own
encoder, zlib where ``zstandard`` is missing), so each package's client
talks to the other's server.
"""

from __future__ import annotations

import inspect
import threading
import time
import traceback
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional

from repro_torch.obs.trace import extract_trace, get_tracer
from repro_torch.wire import (
    PayloadDecodeError,
    canonical_bytes,
    decode_payload,
    encode_frame,
    encode_payload,
    payload_digest,
    read_frames,
    unwrap_digested,
)

from .context import Context
from .durable import Interrupted
from .heartbeat import HeartbeatServer

__all__ = [
    "TaskRegistry",
    "WorkerServer",
    "WorkerClient",
    "InProcWorker",
    "FlakyWorker",
    "Middleware",
    "WorkerStreamError",
    "STREAM_CONTENT_TYPE",
]

Middleware = Callable[[str, Mapping[str, Any]], Optional[str]]
# middleware(task_name, meta) -> None (pass) or str (rejection reason)

STREAM_CONTENT_TYPE = "application/x-serpytor-stream"


class WorkerStreamError(RuntimeError):
    """A worker-side task failure reported mid-stream (via an error frame)."""


class TaskRegistry:
    """name → atomic task. Weakly opinionated: anything callable registers."""

    def __init__(self) -> None:
        self._tasks: Dict[str, Callable[..., Any]] = {}

    def register(self, name: str, fn: Callable[..., Any]) -> None:
        self._tasks[name] = fn

    def task(self, name: str):
        def wrap(fn: Callable[..., Any]) -> Callable[..., Any]:
            self.register(name, fn)
            return fn

        return wrap

    def get(self, name: str) -> Callable[..., Any]:
        if name not in self._tasks:
            raise KeyError(f"unknown task {name!r}")
        return self._tasks[name]

    def names(self) -> List[str]:
        return sorted(self._tasks)


class _WorkerState:
    def __init__(self) -> None:
        self.busy = 0
        self.completed = 0
        self.failed = 0
        self.lock = threading.Lock()


def _execute(
    registry: TaskRegistry,
    middleware: List[Middleware],
    state: _WorkerState,
    task_name: str,
    ctx: Context,
    inputs: Mapping[str, Any],
    fail_injector: Optional[Callable[[str], None]] = None,
) -> Dict[str, Any]:
    # the one worker-side execution contract, shared by every transport
    # (in-proc, threaded HTTP) — which is also why the task span is opened
    # here and nowhere transport-specific. Parent identity rides the
    # submitted context as an obs.* fact (see repro_torch.obs.trace).
    tracer = get_tracer()
    if not tracer.enabled:
        return _execute_inner(
            registry, middleware, state, task_name, ctx, inputs, fail_injector
        )
    parent = extract_trace(ctx)
    span = tracer.start_span(
        f"task:{task_name}",
        trace_id=parent[0] if parent else "",
        parent_id=parent[1] if parent else "",
        kind="task",
        attrs={"task": task_name},
    )
    result = _execute_inner(
        registry, middleware, state, task_name, ctx, inputs, fail_injector
    )
    tracer.end(
        span,
        status=str(result.get("status", "error")),
        attrs={"wall_s": result.get("wall_s", 0.0)},
    )
    return result


def _execute_inner(
    registry: TaskRegistry,
    middleware: List[Middleware],
    state: _WorkerState,
    task_name: str,
    ctx: Context,
    inputs: Mapping[str, Any],
    fail_injector: Optional[Callable[[str], None]] = None,
) -> Dict[str, Any]:
    for mw in middleware:
        reason = mw(task_name, {"inputs": sorted(inputs)})
        if reason is not None:
            return {"status": "rejected", "reason": reason}
    with state.lock:
        state.busy += 1
    t0 = time.monotonic()  # wall_s is a duration: clock steps must not skew it
    try:
        if fail_injector is not None:
            fail_injector(task_name)  # test hook: raise to simulate app error
        fn = registry.get(task_name)
        # tensor-bearing tasks may arrive with Digested digest-hint wrappers
        # when invoked directly (the gateway strips them at submit); the
        # registry surface always hands task functions plain payload values
        out = fn(ctx, **unwrap_digested(dict(inputs)))
        if inspect.isgenerator(out):
            # a stream-source task: the body has not run yet — chunks are
            # produced as the caller (transport) iterates, so accounting
            # (completed/failed) is settled by the transport at stream end,
            # not here. The chunk seq numbering starts at the durable-resume
            # offset the caller sent.
            return {
                "status": "stream",
                "stream": out,
                "start": int(dict(inputs).get("start", 0) or 0),
                "wall_s": time.monotonic() - t0,
            }
        with state.lock:
            state.completed += 1
        # normalize results at the worker boundary: an HTTP transport strips
        # Digested wrappers as a side effect of encoding, so the zero-copy
        # in-proc path must strip them too — otherwise the same task output
        # would journal under transport-dependent digests
        return {
            "status": "ok",
            "output": unwrap_digested(out),
            "wall_s": time.monotonic() - t0,
        }
    except Interrupted as exc:
        # a named interrupt point: NOT a failure — the submitter suspends.
        # Unserializable payloads degrade to repr so the status crosses
        # any transport.
        payload = exc.payload
        if payload is not None:
            try:
                payload_digest(payload)  # probes serializability
            except Exception:
                payload = repr(payload)
        return {
            "status": "interrupt",
            "name": exc.name,
            "payload": payload,
            "wall_s": time.monotonic() - t0,
        }
    except Exception as exc:  # application-level failure: report, stay alive
        with state.lock:
            state.failed += 1
        return {
            "status": "error",
            "error": f"{type(exc).__name__}: {exc}",
            "traceback": traceback.format_exc(),
            "wall_s": time.monotonic() - t0,
        }
    finally:
        with state.lock:
            state.busy -= 1


class InProcWorker:
    """Zero-transport worker — the unit-test and single-process fast path.

    ``max_concurrency`` models the worker's real execution capacity: a
    worker standing in for one accelerator host processes one tensor task
    at a time (``max_concurrency=1``), even though the gateway's dispatch
    pool may hand it several requests concurrently. ``None`` (default)
    keeps the historical unlimited-overlap behaviour for pure-Python tasks.
    """

    def __init__(
        self,
        name: str,
        registry: TaskRegistry,
        middleware: Optional[List[Middleware]] = None,
        max_concurrency: Optional[int] = None,
    ):
        self.name = name
        self.registry = registry
        self.middleware = list(middleware or [])
        self.state = _WorkerState()
        self.alive = True  # system liveness (simulated)
        self.app_alive = True  # application liveness (simulated)
        self.latency_s = 0.0  # injected slowness for straggler tests
        self.fail_injector: Optional[Callable[[str], None]] = None
        self._slots = (
            threading.BoundedSemaphore(max_concurrency) if max_concurrency else None
        )

    # same surface as WorkerClient ------------------------------------------
    def heartbeat(self) -> Optional[Dict[str, Any]]:
        if not self.alive:
            return None
        from .heartbeat import telemetry

        with self.state.lock:
            busy = self.state.busy
        return telemetry(
            {"worker": self.name, "busy": busy, "completed": self.state.completed}
        )

    def run_task(
        self, task_name: str, ctx: Context, inputs: Mapping[str, Any]
    ) -> Dict[str, Any]:
        if not self.alive:
            raise ConnectionError(f"worker {self.name} is down (system-level)")
        if not self.app_alive:
            raise TimeoutError(f"worker {self.name} application not responding")
        if self._slots is None:
            return self._run_task_inner(task_name, ctx, inputs)
        with self._slots:  # capacity-bound execution (one accelerator's worth)
            return self._run_task_inner(task_name, ctx, inputs)

    def _run_task_inner(
        self, task_name: str, ctx: Context, inputs: Mapping[str, Any]
    ) -> Dict[str, Any]:
        if self.latency_s:
            time.sleep(self.latency_s)
        result = _execute(
            self.registry, self.middleware, self.state, task_name, ctx, inputs,
            self.fail_injector,
        )
        if result.get("status") == "stream":
            # zero-transport: the generator body runs on the CONSUMER's
            # thread, so settle completed/failed accounting at stream end
            result["stream"] = self._track_stream(result["stream"])
        return result

    def _track_stream(self, gen: Any):
        try:
            yield from gen
        except Exception:
            with self.state.lock:
                self.state.failed += 1
            raise
        else:
            with self.state.lock:
                self.state.completed += 1


class FlakyWorker(InProcWorker):
    """Deterministic fault injection: an in-proc worker you can kill mid-graph.

    The kill switch flips *system* liveness off — exactly the §3.2 failure the
    heartbeat detector exists for: ``heartbeat()`` returns None and every
    ``run_task`` raises ConnectionError. Two death modes:

      - ``"drop"``  (default): in-flight and new calls fail fast with
        ConnectionError — a clean crash the dispatch path detects itself.
      - ``"hang"``: in-flight calls block (until :meth:`release` or
        ``hang_timeout_s``) before failing — a silent partition; only the
        gateway's heartbeat eviction can recover work stuck on this worker.

    ``kill_after_starts=N`` arms the switch so the Nth task *start* triggers
    it: the worker dies mid-flight with work accepted but never finished,
    which is the scenario requeue-on-eviction must survive.
    """

    def __init__(
        self,
        name: str,
        registry: TaskRegistry,
        *,
        kill_after_starts: Optional[int] = None,
        mode: str = "drop",
        hang_timeout_s: float = 30.0,
        **kw,
    ):
        assert mode in ("drop", "hang")
        super().__init__(name, registry, **kw)
        self.kill_after_starts = kill_after_starts
        self.mode = mode
        self.hang_timeout_s = hang_timeout_s
        self.starts = 0
        self._released = threading.Event()

    def kill(self) -> None:
        """Flip the switch: heartbeat goes dark, tasks fail per ``mode``."""
        self.alive = False

    def release(self) -> None:
        """Unblock any calls parked by ``hang`` mode (test teardown hook)."""
        self._released.set()

    def run_task(
        self, task_name: str, ctx: Context, inputs: Mapping[str, Any]
    ) -> Dict[str, Any]:
        with self.state.lock:
            self.starts += 1
            armed = (
                self.kill_after_starts is not None
                and self.starts >= self.kill_after_starts
            )
        if armed:
            self.kill()
        if not self.alive:
            if self.mode == "hang":
                self._released.wait(self.hang_timeout_s)
            raise ConnectionError(f"worker {self.name} died mid-task ({task_name})")
        return super().run_task(task_name, ctx, inputs)


class _AppHandler(BaseHTTPRequestHandler):
    server_version = "SerPyTorWorker/1.0"

    def do_POST(self) -> None:  # noqa: N802
        if self.path.rstrip("/") != "/task":
            self.send_error(404)
            return
        length = int(self.headers.get("Content-Length", "0"))
        body = self.rfile.read(length)
        try:
            req = decode_payload(body)
            ctx = Context.from_wire(req["context"])
            result = _execute(
                self.server.registry,  # type: ignore[attr-defined]
                self.server.middleware,  # type: ignore[attr-defined]
                self.server.state,  # type: ignore[attr-defined]
                req["task"],
                ctx,
                req["inputs"],
            )
        except Exception as exc:  # malformed request
            result = {"status": "error", "error": str(exc)}
        if result.get("status") == "stream":
            self._send_stream(result)
            return
        out = encode_payload(result)
        self.send_response(200)
        self.send_header("Content-Type", "application/x-msgpack-zstd")
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)

    def _send_stream(self, result: Dict[str, Any]) -> None:
        """Incremental chunk transport: one wire frame per produced chunk.

        HTTP/1.1 chunked transfer-encoding carries self-delimiting frames
        (docs/streaming.md §5): ``{"s": seq, "c": chunk}`` per chunk, a
        terminal ``{"eos": n}``, or ``{"err": msg}`` if the task body fails
        mid-stream — the consumer sees a typed failure, never a silent
        truncation (a torn connection is detected by the missing EOS frame).
        """
        self.send_response(200)
        self.send_header("Content-Type", STREAM_CONTENT_TYPE)
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def emit(frame: bytes) -> None:
            self.wfile.write(f"{len(frame):X}\r\n".encode() + frame + b"\r\n")
            self.wfile.flush()

        seq = int(result.get("start", 0) or 0)
        state = self.server.state  # type: ignore[attr-defined]
        with state.lock:
            state.busy += 1  # the task body runs HERE, not in _execute
        try:
            for chunk in result["stream"]:
                emit(encode_frame({"s": seq, "c": chunk}))
                seq += 1
            emit(encode_frame({"eos": seq}))
            with state.lock:
                state.completed += 1
        except Exception as exc:  # mid-stream task failure: typed error frame
            with state.lock:
                state.failed += 1
            try:
                emit(encode_frame({"err": f"{type(exc).__name__}: {exc}"}))
            except Exception:
                pass  # consumer already gone; nothing left to tell it
        finally:
            with state.lock:
                state.busy -= 1
        try:
            self.wfile.write(b"0\r\n\r\n")  # terminate the chunked body
        except Exception:
            pass

    def do_GET(self) -> None:  # noqa: N802
        if self.path.rstrip("/") == "/tasks":
            body = canonical_bytes(self.server.registry.names())  # type: ignore[attr-defined]
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self.send_error(404)

    def log_message(self, *args) -> None:
        pass


class WorkerServer:
    """Application server + separate heartbeat server (two ports, §3.2)."""

    def __init__(
        self,
        name: str,
        registry: TaskRegistry,
        host: str = "127.0.0.1",
        port: int = 0,
        middleware: Optional[List[Middleware]] = None,
    ):
        self.name = name
        self.registry = registry
        self.state = _WorkerState()
        self._httpd = ThreadingHTTPServer((host, port), _AppHandler)
        self._httpd.registry = registry  # type: ignore[attr-defined]
        self._httpd.middleware = list(middleware or [])  # type: ignore[attr-defined]
        self._httpd.state = self.state  # type: ignore[attr-defined]
        self.host = host
        self.port = self._httpd.server_address[1]
        self.heartbeat_server = HeartbeatServer(host=host, extra={"worker": name})
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "WorkerServer":
        self.heartbeat_server.start()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name=f"worker:{self.name}", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, stop_heartbeat: bool = True) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2)
        if stop_heartbeat:
            self.heartbeat_server.stop()

    def crash_application(self) -> None:
        """Kill ONLY the app server — heartbeat stays up (application-level)."""
        self.stop(stop_heartbeat=False)

    @property
    def address(self) -> str:
        return f"http://{self.host}:{self.port}"

    def __enter__(self) -> "WorkerServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class WorkerClient:
    """HTTP client with the same surface as InProcWorker."""

    def __init__(
        self, name: str, address: str, heartbeat_address: str, timeout: float = 30.0
    ):
        self.name = name
        self.address = address
        self.heartbeat_address = heartbeat_address
        self.timeout = timeout

    def heartbeat(self) -> Optional[Dict[str, Any]]:
        from .heartbeat import check_heartbeat

        return check_heartbeat(self.heartbeat_address, timeout=min(2.0, self.timeout))

    def run_task(
        self, task_name: str, ctx: Context, inputs: Mapping[str, Any]
    ) -> Dict[str, Any]:
        body = encode_payload(
            {"task": task_name, "context": ctx.to_wire(), "inputs": dict(inputs)}
        )
        req = urllib.request.Request(
            self.address.rstrip("/") + "/task", data=body, method="POST"
        )
        try:
            resp = urllib.request.urlopen(req, timeout=self.timeout)
        except Exception as exc:
            raise TimeoutError(f"worker {self.name} application not responding: {exc}") from exc
        if resp.headers.get("Content-Type", "") == STREAM_CONTENT_TYPE:
            # incremental chunk stream: hand back a live frame iterator —
            # the response stays open and is closed when the stream ends
            return {"status": "stream", "stream": _stream_values(resp, self.name)}
        try:
            raw = resp.read()
        except Exception as exc:
            raise TimeoutError(f"worker {self.name} application not responding: {exc}") from exc
        finally:
            resp.close()
        # a transport that answered but with undecodable bytes is a TYPED
        # failure (PayloadDecodeError) — the gateway retries it elsewhere
        return decode_payload(raw)


def _stream_values(resp: Any, worker_name: str) -> Iterator[Any]:
    """Decode chunk frames off an open HTTP response, yielding chunk values.

    Ends at the EOS frame; a worker-side failure frame raises
    :class:`WorkerStreamError`; a connection that dies between frames
    raises :class:`~repro_torch.wire.PayloadDecodeError` (torn stream) so the
    consumer can resume from its last committed offset.
    """
    try:
        for frame in read_frames(resp):
            if "err" in frame:
                raise WorkerStreamError(
                    f"worker {worker_name} failed mid-stream: {frame['err']}"
                )
            if "eos" in frame:
                return
            yield frame["c"]
        raise PayloadDecodeError(
            f"stream from worker {worker_name} ended without an EOS frame"
        )
    finally:
        resp.close()
