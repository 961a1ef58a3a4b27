"""The port's ``ClusterExecutor`` against the JAX package's, on the CPU.

One graph run through each package's ``ClusterExecutor`` over its own
``Gateway`` and ``InProcWorker``s gives the same journal: node ids, kinds,
context and input digests per node; a second run replays everything, and the
traced runs give the same run, node, rpc and task spans. Then the seven tests of
``tests/test_cluster_dataflow.py`` and the three cluster tests of
``tests/test_system.py`` on the port, with the port's ``FlakyWorker`` for
fault injection, and the refusals: stream nodes, the result cache and
interrupt points (ROADMAP Queue 1 item 14).
"""

import inspect
import itertools
import queue
import threading
import time

import pytest

import repro.core as jcore
import repro.obs.trace as jtrace
import repro_torch.core as tcore
import repro_torch.obs.trace as ttrace
from repro_torch.core import (
    ClusterExecutor,
    Context,
    ContextGraph,
    FlakyWorker,
    Gateway,
    InProcWorker,
    Interrupted,
    Journal,
    TaskRegistry,
    WithContext,
)


@pytest.fixture
def flaky():
    """The port's ``FlakyWorker``s made by a test, released (hung calls unparked) at the
    end."""
    made = []

    def make(name, registry, *, after=1, **kw):
        worker = FlakyWorker(name, registry, kill_after_starts=after, **kw)
        made.append(worker)
        return worker

    yield make
    for worker in made:
        worker.release()


# --------------------------------------------------------------------------
# one graph through both packages
# --------------------------------------------------------------------------


def _graph(core):
    """Named tasks fanned out and folded by gateway-side callables, a volatile node, a
    WithContext fact read by a task downstream."""
    g = core.ContextGraph(origin=core.Context.origin({"run": "cluster"}), name="cluster")
    g.add("src", lambda ctx: core.WithContext(3, {"flavor": "durian"}), data={"k": 1})
    for i in range(4):
        g.add(f"map{i}", "scale", deps=["src"], aliases={"src": "x"}, data={"i": i})
    g.add("fold", lambda ctx, **kw: sum(kw.values()), deps=[f"map{i}" for i in range(4)])
    g.add("tag", "flavor", deps=["fold"])
    g.add("vol", lambda ctx, fold: [fold] * 3, deps=["fold"], volatile=True)
    return g


def _registry(core):
    reg = core.TaskRegistry()
    reg.register("scale", lambda ctx, x: x * (int(ctx.get("i")) + 1))
    reg.register("flavor", lambda ctx, fold: f"{ctx.get('flavor')}:{fold}")
    return reg


def _run_cluster(core, path):
    reg = _registry(core)
    with core.Journal(path, sync="batch") as j:
        with core.Gateway([core.InProcWorker(f"w{i}", reg) for i in range(3)]) as gw:
            return core.ClusterExecutor(gw, journal=j, speculative=False).run(_graph(core))


def _records(core, path):
    out = {}
    for rec in core.Journal(path, sync="never").records():
        fields = (rec.context_digest, rec.input_digest, rec.output_digest, rec.attempt)
        out.setdefault((rec.kind, rec.node_id), []).append(fields + (rec.payload,))
    return out


def test_one_graph_gives_the_references_journal_and_replays(tmp_path):
    runs = {}
    for name, core in (("torch", tcore), ("jax", jcore)):
        path = str(tmp_path / f"{name}.wal")
        first = _run_cluster(core, path)
        assert sorted(first.executed) == sorted(
            ["src", "map0", "map1", "map2", "map3", "fold", "tag", "vol"]
        )
        assert first.outputs["fold"] == 30 and first.outputs["tag"] == "durian:30"
        again = _run_cluster(core, path)
        assert again.executed == ("vol",)  # volatile: re-executed and verified
        assert sorted(again.replayed) == sorted(set(first.executed) - {"vol"})
        assert again.outputs["tag"] == first.outputs["tag"]
        runs[name] = _records(core, path)
    assert runs["torch"] == runs["jax"]
    kinds = {k[0] for k in runs["torch"]}
    assert kinds == {"RUN_START", "NODE_START", "NODE_COMMIT", "RUN_END"}
    vol = runs["torch"]["NODE_COMMIT", "vol"]
    assert len(vol) == 2 and vol[0] == vol[1] and vol[0][-1] is None  # digest only


class _Sink:
    def __init__(self):
        self.spans = []
        self.lock = threading.Lock()

    def emit(self, obj):
        with self.lock:
            self.spans.append(obj)


def _traced(core, trace):
    sink = _Sink()
    reg = _registry(core)
    with trace.get_tracer().attached(sink):
        with core.Gateway([core.InProcWorker("w0", reg)]) as gw:
            core.ClusterExecutor(gw, speculative=False).run(_graph(core))
    names = {s["span"]: s["name"] for s in sink.spans}
    return sorted(
        (s["name"], s["kind"], s["status"], names.get(s["parent"], s["parent"]))
        for s in sink.spans
    )


def test_a_traced_run_gives_the_references_spans():
    got = _traced(tcore, ttrace)
    assert got == _traced(jcore, jtrace)
    assert ("run:cluster", "run", "ok", "") in got
    assert ("map0", "node", "ok", "run:cluster") in got
    assert ("task:scale", "task", "ok", "map0") in got
    assert ("fold", "node", "ok", "run:cluster") in got


# --------------------------------------------------------------------------
# tests/test_cluster_dataflow.py, mirrored
# --------------------------------------------------------------------------


def test_child_dispatches_before_unrelated_sibling_finishes():
    """The defining dataflow property: dependency-ready beats level-complete."""
    reg = TaskRegistry()
    release = threading.Event()
    order = queue.Queue()  # the tasks' finishing order, without mutating captured lists

    @reg.task("blocker")
    def blocker(ctx):
        release.wait(10.0)
        order.put("blocker")
        return "blocker-done"

    @reg.task("fast")
    def fast(ctx):
        return "fast-done"

    @reg.task("child")
    def child(ctx, **kw):
        order.put("child")
        release.set()
        return "child-done"

    workers = [InProcWorker(f"w{i}", reg) for i in range(3)]
    g = ContextGraph(name="barrier-free")
    g.add("slow", "blocker")
    g.add("quick", "fast")
    g.add("dependent", "child", deps=["quick"])
    t0 = time.time()
    with Gateway(workers) as gw:
        rep = ClusterExecutor(gw, speculative=False).run(g)
    assert order.get_nowait() == "child"  # ran while same-level "slow" was still blocked
    assert rep.outputs["dependent"] == "child-done"
    assert rep.outputs["slow"] == "blocker-done"
    assert time.time() - t0 < 9.0  # would be ~10 s under a level barrier


def test_cluster_wait_path_has_no_sleep_polling():
    src = inspect.getsource(ClusterExecutor)
    assert "time.sleep" not in src  # completions arrive via Condition.wait


def test_worker_killed_mid_graph_run_completes(tmp_path, flaky):
    """Fast-crash death: the first task landing on w0 kills it mid-flight."""
    reg = TaskRegistry()

    @reg.task("work")
    def work(ctx, **kw):
        time.sleep(0.005)
        return sum(v for v in kw.values() if isinstance(v, int)) + 1

    w0 = flaky("w0", reg, after=1)
    workers = [w0, InProcWorker("w1", reg), InProcWorker("w2", reg)]
    g = ContextGraph(name="kill-mid-run")
    for i in range(8):
        g.add(f"a{i}", "work")
        g.add(f"b{i}", "work", deps=[f"a{i}"])
    path = str(tmp_path / "kill.wal")
    with Journal(path, sync="batch") as j:
        with Gateway(workers, heartbeat_interval_s=0.05) as gw:
            rep = ClusterExecutor(gw, journal=j, speculative=False).run(g)
            # eviction from the pool: the dead worker is no longer allocatable
            assert "w0" not in [h.name for h in gw.live_workers()]
        assert w0.starts >= 1  # it really did accept work before dying
        assert all(rep.outputs[f"b{i}"] == 2 for i in range(8))
        # requeues are journaled with attempt counts
        requeues = [r for r in j.records() if r.kind == "NODE_REQUEUE"]
        assert requeues, "worker death must journal at least one NODE_REQUEUE"
        assert all(r.attempt >= 1 for r in requeues)
        assert all(r.node_id and r.meta.get("reason") for r in requeues)
        kinds = j.kinds()
        assert kinds["NODE_COMMIT"] == 16
        assert kinds["RUN_END"] == 1


def test_hung_worker_recovered_by_heartbeat_eviction(flaky):
    """Silent-partition death: the task hangs, only the heartbeat can tell."""
    reg = TaskRegistry()

    @reg.task("work")
    def work(ctx):
        time.sleep(0.005)
        return 1

    w0 = flaky("w0", reg, after=1, mode="hang", hang_timeout_s=5.0)
    workers = [w0, InProcWorker("w1", reg)]
    g = ContextGraph(name="hang-recovery")
    for i in range(6):
        g.add(f"t{i}", "work")
    with Gateway(workers, heartbeat_interval_s=0.05) as gw:
        rep = ClusterExecutor(gw, speculative=False).run(g)
        w0.release()  # unpark the stuck dispatch thread before shutdown
    assert all(rep.outputs[f"t{i}"] == 1 for i in range(6))
    assert gw.metrics["evicted"] >= 1  # recovery came from the heartbeat path


def test_failure_scarred_journal_replays_clean(tmp_path, flaky):
    """A run that survived a worker death leaves a fully replayable journal."""
    reg = TaskRegistry()

    @reg.task("work")
    def work(ctx, **kw):
        return sum(v for v in kw.values() if isinstance(v, int)) + 1

    g = ContextGraph(name="replay-after-failure")
    for i in range(5):
        g.add(f"a{i}", "work")
        g.add(f"b{i}", "work", deps=[f"a{i}"])
    path = str(tmp_path / "scarred.wal")

    workers = [flaky("w0", reg, after=1), InProcWorker("w1", reg)]
    with Journal(path, sync="batch") as j:
        with Gateway(workers, heartbeat_interval_s=0.05) as gw:
            r1 = ClusterExecutor(gw, journal=j, speculative=False).run(g)

    survivors = [InProcWorker("w1", reg)]
    with Journal(path, sync="batch") as j:
        with Gateway(survivors) as gw:
            r2 = ClusterExecutor(gw, journal=j, speculative=False).run(g)
    assert r2.executed == ()  # zero re-execution
    assert set(r2.replayed) == set(r1.executed)
    assert r2.outputs == r1.outputs


def test_callable_withcontext_facts_survive_replay(tmp_path):
    """Gateway-side WithContext facts are journaled and re-emitted on replay,
    keeping downstream ξ digests identical (zero re-execution)."""
    reg = TaskRegistry()

    @reg.task("consume")
    def consume(ctx, **kw):
        return ctx.get("flavor", "missing")

    def emit(ctx):
        return WithContext("out", {"flavor": "durian"})

    g = ContextGraph(name="facts-replay")
    g.add("emitter", emit)
    g.add("reader", "consume", deps=["emitter"])
    path = str(tmp_path / "facts.wal")
    with Journal(path, sync="batch") as j:
        with Gateway([InProcWorker("w0", reg)]) as gw:
            r1 = ClusterExecutor(gw, journal=j).run(g)
    with Journal(path, sync="batch") as j:
        with Gateway([InProcWorker("w0", reg)]) as gw:
            r2 = ClusterExecutor(gw, journal=j).run(g)
    assert r1.outputs["reader"] == "durian"
    assert r2.executed == ()  # facts re-emitted, digests identical, all replayed
    assert r2.outputs == r1.outputs


def test_global_speculation_covers_cross_level_straggler():
    """Speculation is global: a straggler deep in the graph still gets a copy
    while unrelated shallow nodes keep committing around it."""
    reg = TaskRegistry()
    starts = itertools.count(1)  # next() is atomic: no captured state mutated by hand

    @reg.task("work")
    def work(ctx, **kw):
        n = next(starts)
        time.sleep(2.0 if n == 7 else 0.01)  # one pathological straggler
        return sum(v for v in kw.values() if isinstance(v, int)) + 1

    workers = [InProcWorker(f"w{i}", reg) for i in range(3)]
    g = ContextGraph(name="global-speculation")
    for i in range(6):
        g.add(f"a{i}", "work")
        g.add(f"b{i}", "work", deps=[f"a{i}"])
    with Gateway(workers) as gw:
        ex = ClusterExecutor(gw, speculative=True, speculation_tick_s=0.02)
        ex.straggler.threshold = 3.0
        t0 = time.time()
        rep = ex.run(g)
        wall = time.time() - t0
    assert all(rep.outputs[f"b{i}"] == 2 for i in range(6))
    # the run returned well before the 2 s straggler could have finished,
    # and an extra (speculative) task execution was dispatched to cover it
    assert wall < 1.5
    assert next(starts) - 1 >= 13


# --------------------------------------------------------------------------
# tests/test_system.py's cluster tests, mirrored
# --------------------------------------------------------------------------


def _cluster(n=3):
    reg = TaskRegistry()
    return reg, [InProcWorker(f"w{i}", reg) for i in range(n)]


def test_cluster_executor_runs_named_task_graph(tmp_path):
    reg, workers = _cluster()
    reg.register("double", lambda ctx, **kw: 2 * list(kw.values())[0])
    g = ContextGraph(origin=Context.origin({"run": "map-reduce"}))
    for i in range(6):
        g.add(f"in{i}", lambda ctx, _i=i: _i)
        g.add(f"map{i}", "double", deps=[f"in{i}"])
    g.add(
        "sum",
        lambda ctx, **kw: sum(v for v in kw.values() if isinstance(v, int)),
        deps=[f"map{i}" for i in range(6)],
    )
    with Gateway(workers) as gw:
        with Journal(str(tmp_path / "c.wal"), sync="batch") as j:
            rep = ClusterExecutor(gw, journal=j).run(g)
    assert rep.outputs["sum"] == sum(2 * i for i in range(6))


def test_cluster_executor_survives_worker_death(tmp_path):
    reg, workers = _cluster(3)
    reg.register("slowish", lambda ctx: time.sleep(0.01) or 1)
    g = ContextGraph()
    for i in range(12):
        g.add(f"t{i}", "slowish")
    with Gateway(workers, heartbeat_interval_s=0.05) as gw:
        workers[0].alive = False  # dies before dispatch completes
        rep = ClusterExecutor(gw, speculative=False).run(g)
    assert all(rep.outputs[f"t{i}"] == 1 for i in range(12))


def test_speculative_execution_covers_straggler():
    reg, workers = _cluster(2)
    calls = {"n": 0}

    def sometimes_slow(ctx):
        calls["n"] += 1
        if calls["n"] == 5:  # one pathological straggler
            time.sleep(1.0)
        else:
            time.sleep(0.01)
        return 1

    reg.register("work", sometimes_slow)
    g = ContextGraph()
    for i in range(8):
        g.add(f"t{i}", "work")
    with Gateway(workers) as gw:
        ex = ClusterExecutor(gw, speculative=True)
        ex.straggler.threshold = 3.0
        t0 = time.time()
        rep = ex.run(g)
        wall = time.time() - t0
    assert all(rep.outputs[f"t{i}"] == 1 for i in range(8))
    assert wall < 5.0  # did not serialize behind the straggler


# --------------------------------------------------------------------------
# refusals: ROADMAP Queue 1 item 14
# --------------------------------------------------------------------------


def test_streams_and_the_cache_are_refused_by_name():
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        ContextGraph().add("s", "source_task", stream="source")
    reg, workers = _cluster(1)
    with Gateway(workers) as gw:
        for kw in ({"cache": object()}, {"spill_put": lambda n, v: n}):
            with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
                ClusterExecutor(gw, **kw)


def test_interrupts_are_refused_by_name_not_suspended(tmp_path):
    """An inline callable raising Interrupted, and a worker answering with an interrupt
    status, each raise the refusal: the run neither hangs nor suspends."""
    reg, workers = _cluster(1)

    @reg.task("ask")
    def ask(ctx, **kw):
        raise Interrupted("approve", {"q": 1})

    def inline(ctx, **kw):
        raise Interrupted("inline", None)

    for fn, name in ((inline, "inline"), ("ask", "approve")):
        g = ContextGraph(name=f"interrupt-{name}")
        g.add("first", lambda ctx: 1)
        g.add("stop", fn, deps=["first"])
        path = str(tmp_path / f"{name}.wal")
        with Journal(path, sync="batch") as j:
            with Gateway(workers) as gw:
                with pytest.raises(NotImplementedError, match="Queue 1 item 14") as err:
                    ClusterExecutor(gw, journal=j, speculative=False).run(g)
            kinds = j.kinds()
        assert repr(name) in str(err.value)
        assert "SUSPEND" not in kinds and "RUN_END" not in kinds
        assert kinds["NODE_COMMIT"] == 1  # "first" committed before the refusal
