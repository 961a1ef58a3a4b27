"""The port's gateway, workers, tracer and stream frames against the JAX package's.

``repro_torch.core.gateway`` and ``repro_torch.core.server`` are copies of
``repro.core.gateway`` and ``repro.core.server``: the 14 tests of
``tests/test_gateway.py`` and the HTTP, middleware and app-error tests of
``tests/test_heartbeat.py`` run here on the port with the reference's own
bounds. Then what the two packages share is held equal: stream frames and
``Digested`` digests byte for byte, the spans one gateway run emits, and a
task run by each package's client on the other's HTTP worker. Last, the
refusal of the asyncio runtime and the launch counters under threads.
"""

import inspect
import io
import random
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import repro.core as jcore
import repro.obs.trace as jtrace
import repro.wire as jwire
import repro.wire.payload as jpayload
import repro_torch.core as tcore
import repro_torch.obs.trace as ttrace
import repro_torch.wire as twire
from repro_torch.core import (
    AllocationError,
    Context,
    FlakyWorker,
    Gateway,
    HeartbeatServer,
    InProcWorker,
    TaskRegistry,
    WorkerClient,
    WorkerHandle,
    WorkerServer,
    context_affinity,
    least_loaded,
    power_of_two,
    round_robin,
)
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rglru as rg
from repro_torch.kernels import wkv6 as wk
from repro_torch.wire import PayloadDecodeError

SETTINGS = settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])

# --------------------------------------------------------------------------
# tests/test_gateway.py, on the port
# --------------------------------------------------------------------------


def _cluster(n=4, fail=None):
    reg = TaskRegistry()

    @reg.task("add")
    def add(ctx, a, b):
        return a + b

    @reg.task("slow")
    def slow(ctx, dt=0.05):
        time.sleep(dt)
        return dt

    @reg.task("whoami")
    def whoami(ctx):
        return ctx.get("gateway", "?")

    @reg.task("boom")
    def boom(ctx):
        raise ValueError("app error")

    return reg, [InProcWorker(f"w{i}", reg) for i in range(n)]


def test_basic_dispatch_and_result():
    reg, workers = _cluster()
    with Gateway(workers) as gw:
        fut = gw.submit("add", inputs={"a": 2, "b": 3})
        assert fut.result(timeout=5) == 5


def test_round_robin_spreads_load():
    reg, workers = _cluster(3)
    with Gateway(workers, allocation=("round_robin",)) as gw:
        futs = gw.map("add", [{"a": i, "b": 0} for i in range(9)])
        [f.result(timeout=5) for f in futs]
    counts = [w.state.completed for w in workers]
    assert sum(counts) == 9 and max(counts) <= 5  # roughly spread


class _Recording(InProcWorker):
    """An in-process worker that notes the order in which it is handed requests."""

    def __init__(self, name, registry):
        super().__init__(name, registry)
        self.order = []

    def run_task(self, task_name, ctx, inputs):
        self.order.append(inputs["tag"])
        return super().run_task(task_name, ctx, inputs)


def test_silo_priority_ordering():
    reg, _ = _cluster(1)
    reg.register("record", lambda ctx, tag: tag)
    worker = _Recording("w0", reg)
    gw = Gateway([worker], silo=True, dispatch_threads=1)
    # enqueue BEFORE starting dispatch so priorities decide order
    gw.submit("record", inputs={"tag": "low"}, priority=9)
    gw.submit("record", inputs={"tag": "high"}, priority=0)
    f = gw.submit("record", inputs={"tag": "mid"}, priority=5)
    with gw:
        f.result(timeout=5)
        time.sleep(0.1)
    order = worker.order
    assert order[0] == "high" and set(order) == {"low", "mid", "high"}


def test_system_failure_reroutes_to_live_worker():
    reg, workers = _cluster(2)
    workers[0].alive = False  # system-level death: heartbeat gone
    with Gateway(workers, heartbeat_interval_s=0.05) as gw:
        fut = gw.submit("add", inputs={"a": 1, "b": 1})
        assert fut.result(timeout=5) == 2
    assert workers[1].state.completed >= 1


def test_application_failure_distinguished():
    """App raises -> status error -> retries -> surfaced; heartbeat stays OK."""
    reg, workers = _cluster(2)
    with Gateway(workers) as gw:
        fut = gw.submit("boom", max_attempts=2)
        with pytest.raises(RuntimeError):
            fut.result(timeout=5)
        assert all(h.live for h in gw.handles)  # system-level all healthy


def test_all_workers_down_allocation_error():
    reg, workers = _cluster(2)
    for w in workers:
        w.alive = False
    with Gateway(workers, heartbeat_interval_s=0.05) as gw:
        fut = gw.submit("add", inputs={"a": 1, "b": 1}, max_attempts=1)
        with pytest.raises((AllocationError, TimeoutError, ConnectionError)):
            fut.result(timeout=10)


def test_worker_down_callback_fires():
    reg, workers = _cluster(2)
    downs = []
    gw = Gateway(workers, heartbeat_interval_s=0.05)
    gw.on_worker_down = lambda h: downs.append(h.name)
    with gw:
        workers[0].alive = False
        deadline = time.time() + 5
        while not downs and time.time() < deadline:
            time.sleep(0.02)
    assert "w0" in downs


def test_heartbeat_eviction_requeues_inflight_requests():
    """A hung worker's in-flight requests move to survivors via the heartbeat
    monitor — the dispatch path alone would block on the dead transport."""
    reg, workers = _cluster(1)
    flaky = FlakyWorker("wx", reg, kill_after_starts=1, mode="hang", hang_timeout_s=5.0)
    requeues = []
    with Gateway([flaky] + workers, heartbeat_interval_s=0.05) as gw:
        gw.on_requeue = lambda req, reason: requeues.append(reason)
        futs = gw.map("slow", [{"dt": 0.1}] * 4)
        assert [f.result(timeout=5) for f in futs] == [0.1] * 4
        flaky.release()
    assert gw.metrics["evicted"] >= 1
    assert any("evicted" in r for r in requeues)


def test_context_affinity_prefers_holder():
    reg, workers = _cluster(3)
    with Gateway(workers, allocation=("context_affinity", "least_loaded")) as gw:
        gw.submit("add", inputs={"a": 0, "b": 0}, affinity_key="shard7").result(timeout=5)
        holder = [h.name for h in gw.handles if "shard7" in h.held_contexts]
        assert len(holder) == 1
        for _ in range(5):
            gw.submit("add", inputs={"a": 0, "b": 0}, affinity_key="shard7").result(timeout=5)
        holders_after = [h.name for h in gw.handles if "shard7" in h.held_contexts]
        assert holders_after == holder  # affinity kept routing to the same worker


def test_allocation_algorithms_pure():
    handles = [WorkerHandle(worker=None, name=f"w{i}") for i in range(4)]
    handles[2].inflight = 5
    req = type("R", (), {"affinity_key": "", "task_name": "t"})()
    assert least_loaded(handles, req, {}).name != "w2"
    assert power_of_two(handles, req, {"rng": random.Random(0)}) is not None
    assert round_robin(handles, req, {}) is not None
    assert context_affinity(handles, req, {}) is None  # no key -> falls through
    handles[1].held_contexts.add("k")
    req2 = type("R", (), {"affinity_key": "k", "task_name": "t"})()
    assert context_affinity(handles, req2, {}).name == "w1"


def test_cluster_context_snapshot():
    reg, workers = _cluster(2)
    with Gateway(workers) as gw:
        gw.submit("add", inputs={"a": 1, "b": 2}).result(timeout=5)
        ctx = gw.cluster_context()
        assert ctx.get("worker/w0/live") in (True, False)
        assert "worker/w1/live" in ctx.keys()


def test_stats_snapshot_telemetry():
    """Gateway.stats(): per-worker probe latency, inflight/queue depths."""
    reg, workers = _cluster(2)
    with Gateway(workers, heartbeat_interval_s=0.05) as gw:
        futs = gw.map("add", [{"a": i, "b": 1} for i in range(6)])
        [f.result(timeout=5) for f in futs]
        snap = gw.stats()
    assert set(snap["workers"]) == {"w0", "w1"}
    for w in snap["workers"].values():
        assert w["live"] is True and w["app_live"] is True
        assert isinstance(w["inflight"], int) and w["inflight"] >= 0
        assert w["probe_latency_s"] >= 0.0  # stamped even for in-proc workers
        assert w["hb_misses"] == 0
    assert sum(w["completed"] for w in snap["workers"].values()) >= 6
    assert snap["queue_depth"] == 0 and snap["silo_depth"] == 0
    assert snap["live_workers"] == 2
    assert snap["metrics"]["scheduled"] >= 6
    assert snap["mean_alloc_us"] >= 0.0


class _CorruptHandler(BaseHTTPRequestHandler):
    """An application server that answers /task with undecodable bytes."""

    def do_POST(self):  # noqa: N802
        body = b"\xde\xad\xbe\xef not a payload frame"
        self.send_response(200)
        self.send_header("Content-Type", "application/x-msgpack-zstd")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


class _CorruptWorker:
    """A real HTTP worker (live heartbeat) whose responses are corrupt."""

    def __init__(self):
        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), _CorruptHandler)
        threading.Thread(target=self._httpd.serve_forever, daemon=True).start()
        self.heartbeat_server = HeartbeatServer().start()
        host, port = self._httpd.server_address
        self.client = WorkerClient(
            "corrupt", f"http://{host}:{port}", self.heartbeat_server.address, timeout=5.0
        )

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self.heartbeat_server.stop()


def test_corrupt_http_payload_surfaces_typed_error():
    """An HTTP worker returning undecodable bytes surfaces PayloadDecodeError."""
    corrupt = _CorruptWorker()
    try:
        with Gateway([corrupt.client], heartbeat_interval_s=0.1) as gw:
            fut = gw.submit("add", inputs={"a": 1, "b": 1}, max_attempts=2)
            with pytest.raises(PayloadDecodeError):
                fut.result(timeout=10)
            assert gw.metrics["corrupt"] >= 1
    finally:
        corrupt.stop()


def test_corrupt_worker_retried_on_healthy_worker():
    """The corrupt worker is quarantined (app level) and the request requeued on a
    healthy HTTP worker: the caller never sees the error."""
    reg = TaskRegistry()
    reg.register("add", lambda ctx, a, b: a + b)
    corrupt = _CorruptWorker()
    try:
        with WorkerServer("healthy", reg) as ws:
            healthy = WorkerClient("healthy", ws.address, ws.heartbeat_server.address)
            # long heartbeat interval: a probe mid-test would self-heal app_live
            with Gateway(
                [corrupt.client, healthy], allocation=("round_robin",), heartbeat_interval_s=5.0
            ) as gw:
                futs = gw.map("add", [{"a": i, "b": i} for i in range(6)])
                assert [f.result(timeout=15) for f in futs] == [2 * i for i in range(6)]
                assert gw.metrics["corrupt"] >= 1
                assert gw.metrics["requeued"] >= 1
                corrupt_handle = next(h for h in gw.handles if h.name == "corrupt")
                assert corrupt_handle.app_live is False  # quarantined
    finally:
        corrupt.stop()


def test_allocation_fast():
    """§5: gateway decisions must not become the scaled-up bottleneck."""
    reg, workers = _cluster(8)
    with Gateway(workers, allocation=("least_loaded",)) as gw:
        futs = gw.map("add", [{"a": i, "b": i} for i in range(200)])
        [f.result(timeout=10) for f in futs]
        assert gw.mean_alloc_us() < 1000  # < 1ms/decision


# --------------------------------------------------------------------------
# tests/test_heartbeat.py's worker tests (:26, :40, :83, :92), on the port
# --------------------------------------------------------------------------


def test_worker_server_task_over_http():
    reg = TaskRegistry()

    @reg.task("mul")
    def mul(ctx, x, y):
        return x * y

    with WorkerServer("w0", reg) as ws:
        client = WorkerClient("w0", ws.address, ws.heartbeat_server.address)
        assert client.heartbeat() is not None
        out = client.run_task("mul", Context.origin({"z": 1}), {"x": 6, "y": 7})
        assert out["status"] == "ok" and out["output"] == 42


def test_system_vs_application_failure_split():
    """The paper's §3.2 troubleshooting matrix, end to end over HTTP."""
    reg = TaskRegistry()
    reg.register("noop", lambda ctx: None)
    ws = WorkerServer("w0", reg).start()
    client = WorkerClient("w0", ws.address, ws.heartbeat_server.address, timeout=1.0)

    assert client.heartbeat() is not None
    assert client.run_task("noop", Context(), {})["status"] == "ok"

    ws.crash_application()  # application-level failure: app down, heartbeat alive
    assert client.heartbeat() is not None
    with pytest.raises(TimeoutError):
        client.run_task("noop", Context(), {})

    ws.heartbeat_server.stop()  # system-level failure: heartbeat down too
    assert client.heartbeat() is None


def test_middleware_rejection():
    reg = TaskRegistry()
    reg.register("secret", lambda ctx: "classified")

    def deny(name, meta):
        return "forbidden" if name == "secret" else None

    w = InProcWorker("w0", reg, middleware=[deny])
    out = w.run_task("secret", Context(), {})
    assert out["status"] == "rejected" and out["reason"] == "forbidden"


def test_application_error_reported_not_crashing():
    reg = TaskRegistry()
    reg.register("div", lambda ctx, x: 1 / x)
    w = InProcWorker("w0", reg)
    out = w.run_task("div", Context(), {"x": 0})
    assert out["status"] == "error" and "ZeroDivisionError" in out["error"]
    assert w.heartbeat() is not None  # worker survives the app error


# --------------------------------------------------------------------------
# stream frames and Digested, across packages
# --------------------------------------------------------------------------


@st.composite
def _arrays(draw):
    dtype = draw(st.sampled_from((np.float32, np.float64, np.int32, np.int64, np.uint8)))
    shape = draw(st.lists(st.integers(0, 3), max_size=3))
    rng = np.random.default_rng(draw(st.integers(0, 2**31)))
    return (rng.standard_normal(shape) * 100).astype(dtype)


_LEAVES = st.one_of(
    st.none(),
    st.booleans(),
    st.integers(-(2**63), 2**64 - 1),
    st.floats(allow_nan=False),
    st.text(max_size=20),
    st.binary(max_size=100),
    _arrays(),
)
_TREES = st.recursive(
    _LEAVES,
    lambda children: st.one_of(
        st.lists(children, max_size=8), st.dictionaries(st.text(max_size=6), children, max_size=8)
    ),
    max_leaves=25,
)


@SETTINGS
@given(_TREES)
def test_encode_frame_gives_the_references_bytes(tree):
    frame = twire.encode_frame({"s": 3, "c": tree})
    assert frame == jwire.encode_frame({"s": 3, "c": tree})
    assert twire.FRAME_HEADER.format == jpayload.FRAME_HEADER.format == "<II"


@SETTINGS
@given(st.lists(_TREES, min_size=1, max_size=4))
def test_read_frames_decodes_either_packages_frames(trees):
    stream = b"".join(
        (twire.encode_frame if i % 2 else jwire.encode_frame)({"s": i, "c": t})
        for i, t in enumerate(trees)
    )
    for read in (twire.read_frames, jwire.read_frames):
        got = list(read(io.BytesIO(stream)))
        assert [f["s"] for f in got] == list(range(len(trees)))
        assert [jwire.payload_digest(f["c"]) for f in got] == [
            jwire.payload_digest(jwire.decode_payload(jwire.encode_payload(t))) for t in trees
        ]


def test_read_frames_raises_on_a_torn_or_corrupt_stream():
    stream = jwire.encode_frame({"s": 0, "c": [1, 2]}) + twire.encode_frame({"eos": 1})
    cut_header = len(jwire.encode_frame({"s": 0, "c": [1, 2]})) + 3
    for torn in (stream[:cut_header], stream[:-1]):
        with pytest.raises(PayloadDecodeError, match="torn stream"):
            list(twire.read_frames(io.BytesIO(torn)))
    bad = bytearray(stream)
    bad[-1] ^= 0xFF  # a flipped body byte: the crc no longer matches
    with pytest.raises(PayloadDecodeError, match="crc mismatch"):
        list(twire.read_frames(io.BytesIO(bytes(bad))))
    assert list(twire.read_frames(io.BytesIO(b""))) == []


@SETTINGS
@given(_TREES)
def test_digested_digests_and_frames_equal_across_packages(tree):
    wrapped_t, wrapped_j = twire.Digested.wrap(tree), jwire.Digested.wrap(tree)
    assert wrapped_t.digest == wrapped_j.digest == jwire.payload_digest(tree)
    nested = {"params": wrapped_t, "step": 1}
    assert twire.payload_digest(nested) == jwire.payload_digest({"params": wrapped_j, "step": 1})
    # wrappers are stripped before encoding: the frame is the unwrapped value's
    assert twire.encode_payload(nested) == jwire.encode_payload({"params": tree, "step": 1})
    assert twire.encode_frame([wrapped_t]) == jwire.encode_frame([tree])
    assert twire.unwrap_digested(nested)["params"] is tree


def test_unwrap_digested_is_copy_on_write():
    plain = {"a": [1, (2, 3)], "b": {"c": np.arange(3)}}
    assert twire.unwrap_digested(plain) is plain
    wrapped = {"a": [1, twire.Digested.wrap((2, 3))], "b": plain["b"]}
    out = twire.unwrap_digested(wrapped)
    assert out == {"a": [1, (2, 3)], "b": plain["b"]} and out["b"] is plain["b"]
    assert repr(twire.Digested("x", "0123")) == "Digested(0123)"


# --------------------------------------------------------------------------
# spans: one gateway run, traced in each package
# --------------------------------------------------------------------------


class _Sink:
    def __init__(self):
        self.spans = []
        self.lock = threading.Lock()

    def emit(self, obj):
        with self.lock:
            self.spans.append(obj)


def _traced_run(core, trace):
    reg = core.TaskRegistry()
    reg.register("add", lambda ctx, a, b: a + b)

    def boom(ctx):
        raise ValueError("app error")

    reg.register("boom", boom)
    workers = [core.InProcWorker(f"w{i}", reg) for i in range(2)]
    sink = _Sink()
    tracer = trace.get_tracer()
    with tracer.attached(sink):
        root = tracer.start_span("run", kind="run")
        ctx = trace.inject_trace(core.Context.origin({"session": "s0"}), root)
        with core.Gateway(workers, allocation=("round_robin",)) as gw:
            futs = gw.map("add", [{"a": i, "b": 1} for i in range(3)], ctx)
            assert [f.result(timeout=5) for f in futs] == [1, 2, 3]
            with pytest.raises(RuntimeError, match="app error"):
                gw.submit("boom", ctx, max_attempts=1).result(timeout=5)
        tracer.end(root)
    assert not tracer.enabled
    names = {s["span"]: s["name"] for s in sink.spans}
    assert len({s["trace"] for s in sink.spans}) == 1  # one trace: the root's
    return sorted(
        (s["name"], s["kind"], s["status"], names.get(s["parent"], s["parent"]))
        for s in sink.spans
    )


def test_a_gateway_run_gives_the_references_spans():
    got, want = _traced_run(tcore, ttrace), _traced_run(jcore, jtrace)
    assert got == want
    assert ("rpc:add", "rpc", "ok", "run") in got and ("task:boom", "task", "error", "run") in got
    assert ("run", "run", "ok", "") in got


def test_trace_facts_are_transient_and_digest_free():
    ctx = Context.origin({"session": "s0"})
    span = ttrace.get_tracer().start_span("run")
    traced = ttrace.inject_trace(ctx, span)
    assert ttrace.extract_trace(traced) == (span.trace_id, span.span_id)
    assert traced.digest() == ctx.digest() and traced.max_lamport() == ctx.max_lamport()
    assert ttrace.strip_trace(traced) == ctx and ttrace.extract_trace(ctx) is None
    jctx = jtrace.inject_trace(jcore.Context.origin({"session": "s0"}), span)
    assert jctx.digest() == traced.digest()


# --------------------------------------------------------------------------
# each package's client on the other's HTTP worker
# --------------------------------------------------------------------------


def _mixed_registry(core):
    reg = core.TaskRegistry()

    @reg.task("scale")
    def scale(ctx, x, by):
        return {"y": np.asarray(x) * by, "session": ctx.get("session"), "n": len(x)}

    @reg.task("count")
    def count(ctx, n, start=0):
        for i in range(n):
            yield {"i": i, "sq": np.int64(i * i)}

    @reg.task("boom")
    def boom(ctx):
        raise ValueError("app error")

    return reg


@pytest.mark.parametrize(
    "server_core, client_core",
    [(jcore, tcore), (tcore, jcore)],
    ids=["port_client_on_reference_server", "reference_client_on_port_server"],
)
def test_a_task_runs_across_packages_over_http(server_core, client_core):
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    with server_core.WorkerServer("w0", _mixed_registry(server_core)) as ws:
        client = client_core.WorkerClient("w0", ws.address, ws.heartbeat_server.address)
        assert client.heartbeat()["worker"] == "w0"
        ctx = client_core.Context.origin({"session": "s7"})
        out = client.run_task("scale", ctx, {"x": x, "by": 2.0})
        assert out["status"] == "ok"
        np.testing.assert_array_equal(out["output"]["y"], x * 2.0)
        assert out["output"]["y"].dtype == np.float32
        assert (out["output"]["session"], out["output"]["n"]) == ("s7", 2)
        stream = client.run_task("count", ctx, {"n": 4})
        assert stream["status"] == "stream"
        assert [(c["i"], int(c["sq"])) for c in stream["stream"]] == [(i, i * i) for i in range(4)]
        err = client.run_task("boom", ctx, {})
        assert err["status"] == "error" and "ValueError: app error" in err["error"]


def test_a_failing_stream_reaches_the_client_as_a_typed_error():
    reg = tcore.TaskRegistry()

    @reg.task("half")
    def half(ctx):
        yield 1
        raise ValueError("mid-stream")

    with tcore.WorkerServer("w0", reg) as ws:
        client = tcore.WorkerClient("w0", ws.address, ws.heartbeat_server.address)
        stream = client.run_task("half", Context(), {})["stream"]
        assert next(stream) == 1
        with pytest.raises(tcore.WorkerStreamError, match="mid-stream"):
            next(stream)
        assert ws.state.failed == 1 and ws.state.completed == 0


def test_interrupted_crosses_the_gateway_as_a_suspension():
    reg = tcore.TaskRegistry()

    def ask(ctx):
        raise tcore.Interrupted("approve", {"amount": 3})

    reg.register("ask", ask)
    with tcore.Gateway([tcore.InProcWorker("w0", reg)]) as gw:
        with pytest.raises(tcore.Interrupted) as info:
            gw.submit("ask").result(timeout=5)
    assert (info.value.name, info.value.payload) == ("approve", {"amount": 3})
    assert gw.metrics["requeued"] == 0  # never retried


# --------------------------------------------------------------------------
# refusals and launch counters
# --------------------------------------------------------------------------


def test_async_runtime_is_refused_by_name(monkeypatch):
    monkeypatch.setenv("REPRO_RUNTIME", "async")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 15"):
        tcore.Gateway([])
    monkeypatch.setenv("REPRO_RUNTIME", "threads")
    assert type(tcore.Gateway([])) is tcore.Gateway


def test_launch_counter_keeps_every_count_under_threads():
    def wrapper():
        pass

    wrapper.launches = 0
    threads, per_thread = 16, 4000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def hammer():
            for _ in range(per_thread):
                _build.count_launch(wrapper)

        workers = [threading.Thread(target=hammer) for _ in range(threads)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in workers)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == threads * per_thread


@pytest.mark.parametrize(
    "wrapper",
    [
        fa.flash_attention_fwd,
        fa.flash_attention_bwd,
        da.decode_attention,
        rg.rglru_scan,
        wk.wkv6_chunked,
    ],
    ids=lambda w: w.__name__,
)
def test_every_wrapper_counts_through_the_locked_helper(wrapper):
    src = inspect.getsource(wrapper)
    assert f"count_launch({wrapper.__name__})" in src and ".launches +=" not in src
