"""Executors: run a ContextGraph durably, on a thread pool (``LocalExecutor``) or
through a Gateway (``ClusterExecutor``), copies of ``repro.core.executor``'s.

Execution semantics (the paper's logical flow, §4):
  1. contract SCCs → union nodes (DAG guarantee),
  2. propagate ξ per the union rules,
  3. execute nodes in dependency order with dependency-injected inputs,
  4. journal every commit; replay skips nodes whose (id, ξ-digest, input-digest)
     already committed — durable, effectively-once execution.

Union nodes execute their members as ONE atomic unit (single commit), in
deterministic member order, with intra-group outputs injected among members.
``LocalExecutor`` runs tasks on a thread pool with dependency-counted
readiness (maximum overlap). ``ClusterExecutor`` dispatches named tasks
through a Gateway to in-process or HTTP workers with the same barrier-free
dependency-counted readiness, event-driven completion consumption, global
straggler speculation and requeue-on-eviction fault tolerance (first commit
wins; duplicates are idempotent by replay), and runs callables on the
gateway side. The journal records, the replay, ``NODE_FAIL``,
``NODE_REQUEUE`` and the retry semantics are the reference's, record for
record (``tests/test_torch_core.py`` and ``tests/test_torch_cluster.py`` run
one graph through both packages' executors).

Not copied, and refused where a caller asks for them (ROADMAP Queue 1 item
14): the cross-run result cache (``cache=``), the spill store (``spill_put=``
/ ``spill_get=``), stream stages and suspension at interrupt points (an
inline callable raising ``Interrupted``, or a worker answering with an
``"interrupt"`` status, raises ``NotImplementedError`` instead of
suspending). ``LocalExecutor`` opens no tracer spans; ``ClusterExecutor``
opens the reference's run and node spans.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

from repro_torch.obs.trace import get_tracer, inject_trace
from repro_torch.wire import payload_digest, unwrap_digested

from .context import Context
from .durable import Interrupted, Journal, JournalRecord, ReplayCache
from .failure import RetryPolicy, StragglerWatch
from .gateway import Gateway
from .graph import ContextGraph, Node, UnionNode

__all__ = ["WithContext", "ExecutionReport", "LocalExecutor", "ClusterExecutor"]

_RUN_TOKENS = itertools.count()  # distinguishes concurrent runs on one gateway


@dataclass
class WithContext:
    """Task return wrapper: ``return WithContext(out, {"fact": 1})`` emits facts."""

    output: Any
    facts: Mapping[str, Any]


@dataclass
class ExecutionReport:
    """What a run did: outputs/contexts per node, and how each node resolved.

    Every exec node lands in exactly one of ``replayed`` (this journal
    already committed it) or ``executed`` (actually ran).
    """

    outputs: Dict[str, Any]
    contexts: Dict[str, Context]
    replayed: Tuple[str, ...]
    executed: Tuple[str, ...]
    wall_s: float


@dataclass
class _Found:
    value: Any
    facts: Optional[Mapping[str, Any]] = None  # journaled WithContext facts
    reexecute: bool = False  # volatile hit: no payload — run again and verify
    expected: Optional[str] = None  # the digest the re-execution must match


class _BaseExecutor:
    """Durable-commit and replay-lookup machinery."""

    def __init__(
        self,
        journal: Optional[Journal] = None,
        retry: Optional[RetryPolicy] = None,
        cache: Any = None,
        spill_put: Any = None,
        spill_get: Any = None,
    ):
        if cache is not None or spill_put is not None or spill_get is not None:
            raise NotImplementedError(
                "the result cache and the spill store are not ported: ROADMAP Queue 1 item 14"
            )
        self.journal = journal
        self.retry = retry or RetryPolicy()
        self.replay = ReplayCache(journal) if journal is not None else ReplayCache()

    # -- durable commit machinery -------------------------------------------
    def _commit(
        self,
        node_id: str,
        ctx_digest: str,
        in_digest: str,
        output: Any,
        attempt: int,
        meta: Optional[dict] = None,
        volatile: bool = False,
        expected: Optional[str] = None,
        deps: Optional[Iterable[str]] = None,
    ) -> None:
        """Journal one NODE_COMMIT and index it for replay.

        ``volatile`` commits carry only the output *digest* (``payload=None``
        — tensors never enter the journal); when ``expected`` is set (the
        digest a previous incarnation committed for the same identity), a
        disagreeing re-execution is surfaced as a hard non-determinism error
        before anything downstream can consume the divergent value.
        ``deps`` (the node's upstream ids) are recorded in ``meta`` for the
        lineage index — provenance annotations the replay oracle ignores.
        """
        if deps:
            meta = {**(meta or {}), "deps": sorted(set(deps))}
        payload = output
        out_digest = payload_digest(output)
        if volatile:
            if expected is not None and expected != out_digest:
                raise RuntimeError(
                    f"non-deterministic re-execution at node {node_id!r}: "
                    f"journal={expected} recomputed={out_digest}"
                )
            payload = None
            meta = {**(meta or {}), "volatile": True}
        rec = JournalRecord(
            kind="NODE_COMMIT",
            node_id=node_id,
            context_digest=ctx_digest,
            input_digest=in_digest,
            output_digest=out_digest,
            payload=payload,
            attempt=attempt,
            meta=meta or {},
        )
        if self.journal is not None:
            self.journal.append(rec)
        self.replay.record(rec)

    @staticmethod
    def _readiness(
        exec_nodes: Mapping[str, Any],
        member_to_group: Mapping[str, str],
    ):
        """Dependency-counted scheduling state: (gdeps, deps_left, children)."""
        gdeps = ContextGraph.group_deps(exec_nodes, member_to_group)
        deps_left = {nid: len(gdeps[nid]) for nid in exec_nodes}
        children: Dict[str, List[str]] = {nid: [] for nid in exec_nodes}
        for nid in exec_nodes:
            for d in gdeps[nid]:
                children[d].append(nid)
        return gdeps, deps_left, children

    def _lookup(self, node_id: str, ctx_digest: str, in_digest: str) -> Optional[_Found]:
        """Replay oracle: the committed output for (node, ξ, inputs), if any.

        Volatile commits carry no payload — they answer with a *verify-only*
        hit (``reexecute=True``): the caller must re-execute the node and
        check the fresh digest against ``expected``. A commit that holds only
        a spill-store ``ref`` cannot be resolved here and re-executes.
        """
        rec = self.replay.lookup(node_id, ctx_digest, in_digest)
        if rec is None:
            return None
        facts = rec.meta.get("facts")
        if rec.meta.get("volatile"):
            return _Found(None, facts, reexecute=True, expected=rec.output_digest)
        if rec.ref:
            return None  # cannot resolve without the spill store; re-execute
        return _Found(rec.payload, facts)


def _inject_inputs(
    node: Node,
    outputs: Mapping[str, Any],
    member_to_group: Mapping[str, str],
) -> Dict[str, Any]:
    """Dependency injection: map each dep's output to the node's kwarg."""
    inputs: Dict[str, Any] = {}
    for dep in node.deps:
        gid = member_to_group.get(dep, dep)
        out = outputs[gid]
        if gid != dep and isinstance(out, Mapping) and dep in out:
            out = out[dep]  # a specific member of a union node
        inputs[node.kwarg_for(dep)] = out
    return inputs


class LocalExecutor(_BaseExecutor):
    """In-process threaded executor with dependency-counted scheduling."""

    def __init__(self, max_workers: int = 8, **kw):
        super().__init__(**kw)
        self.max_workers = max_workers

    def run(
        self,
        graph: ContextGraph,
        run_meta: Optional[Mapping[str, Any]] = None,
    ) -> ExecutionReport:
        """Execute ``graph`` on the thread pool; returns the run's report.

        ``run_meta`` is merged into the RUN_START record. A node that fails
        past its retry budget journals ``NODE_FAIL`` and its error propagates;
        work already in flight drains first, and no ``RUN_END`` is written.
        """
        t0 = time.monotonic()  # wall_s is a duration: clock steps must not skew it
        levels, exec_nodes, member_to_group = graph.schedule()
        outputs: Dict[str, Any] = {}
        out_ctx: Dict[str, Context] = {}
        resolved: Dict[str, List[str]] = {"replayed": [], "executed": []}
        lock = threading.Lock()

        # dependency counting for maximal overlap (scheduling-level deps)
        gdeps, deps_left, children = self._readiness(exec_nodes, member_to_group)
        futures: Dict[Future, str] = {}
        pool = ThreadPoolExecutor(max_workers=self.max_workers)

        if self.journal is not None:
            self.journal.append(
                JournalRecord(
                    kind="RUN_START",
                    node_id=graph.name,
                    meta={"nodes": len(exec_nodes), **dict(run_meta or {})},
                )
            )

        def effective_ctx(nid: str) -> Context:
            node = exec_nodes[nid]
            parents = [out_ctx[d] for d in gdeps[nid]]
            base = Context.union_all(parents) if parents else graph.origin_context
            if isinstance(node, UnionNode):
                for m in sorted(node.members, key=lambda n: n.id):
                    if m.data:
                        base = base.with_data(m.data, origin=m.id)
            elif node.data:
                base = base.with_data(node.data, origin=node.id)
            return base

        def launch(nid: str) -> None:
            f = pool.submit(run_node, nid)
            with lock:
                futures[f] = nid

        def run_node(nid: str) -> None:
            node = exec_nodes[nid]
            ctx = effective_ctx(nid)
            if isinstance(node, UnionNode):
                self._run_union(node, ctx, outputs, member_to_group, resolved, lock)
            else:
                inputs = _inject_inputs(node, outputs, member_to_group)
                value, status = self._run_atomic(node, ctx, inputs)
                with lock:
                    if isinstance(value, WithContext):
                        ctx = ctx.with_data(value.facts, origin=node.id)
                        value = value.output
                    outputs[nid] = value
                    resolved[status].append(nid)
            with lock:
                out_ctx[nid] = ctx

        frontier = [nid for nid, c in deps_left.items() if c == 0]
        try:
            with pool:
                for nid in sorted(frontier):
                    launch(nid)
                while True:
                    with lock:
                        pending = list(futures)
                    if not pending:
                        break
                    done, _ = wait(pending, return_when=FIRST_COMPLETED)
                    for f in done:
                        with lock:
                            nid = futures.pop(f)
                        f.result()  # re-raise task errors
                        for c in children[nid]:
                            with lock:
                                deps_left[c] -= 1
                                ready = deps_left[c] == 0
                            if ready:
                                launch(c)
        finally:
            if self.journal is not None:
                self.journal.flush()

        if self.journal is not None:
            self.journal.append(JournalRecord(kind="RUN_END", node_id=graph.name))
            self.journal.flush()
        return ExecutionReport(
            outputs=outputs,
            contexts=out_ctx,
            replayed=tuple(resolved["replayed"]),
            executed=tuple(resolved["executed"]),
            wall_s=time.monotonic() - t0,
        )

    # -- atomic execution with retries ----------------------------------------
    def _run_atomic(
        self,
        node: Node,
        ctx: Context,
        inputs: Mapping[str, Any],
    ) -> Tuple[Any, str]:
        """Resolve one node; returns (value, "replayed"|"executed")."""
        ctx_d = ctx.digest()
        in_d = payload_digest(inputs)
        hit = self._lookup(node.id, ctx_d, in_d)
        expected: Optional[str] = None
        if hit is not None:
            if hit.reexecute:
                expected = hit.expected  # volatile: run again, verify digest
            elif hit.facts:
                # re-emit journaled context facts so downstream ξ digests
                # match the original run exactly (replay completeness)
                return WithContext(hit.value, hit.facts), "replayed"
            else:
                return hit.value, "replayed"
        if node.fn is None:
            raise ValueError(f"node {node.id!r} has no callable")
        fn_inputs = dict(inputs)
        retry_limit = node.retry_limit(self.retry.max_attempts - 1)
        attempt = 0
        while True:
            try:
                if self.journal is not None:
                    self.journal.append(
                        JournalRecord(
                            kind="NODE_START",
                            node_id=node.id,
                            context_digest=ctx_d,
                            input_digest=in_d,
                            attempt=attempt,
                        )
                    )
                value = node.fn(ctx, **fn_inputs)
                break
            except Exception:
                attempt += 1
                if attempt > retry_limit:
                    if self.journal is not None:
                        self.journal.append(
                            JournalRecord(
                                kind="NODE_FAIL",
                                node_id=node.id,
                                context_digest=ctx_d,
                                input_digest=in_d,
                                attempt=attempt,
                            )
                        )
                    raise
                time.sleep(self.retry.delay(attempt))
        commit_value = value.output if isinstance(value, WithContext) else value
        facts = dict(value.facts) if isinstance(value, WithContext) else None
        meta = {"facts": facts} if facts else None
        self._commit(
            node.id,
            ctx_d,
            in_d,
            commit_value,
            attempt,
            meta=meta,
            volatile=node.volatile,
            expected=expected,
            deps=node.deps,
        )
        return value, "executed"

    def _run_union(
        self,
        group: UnionNode,
        ctx: Context,
        outputs: Dict[str, Any],
        member_to_group: Mapping[str, str],
        resolved: Dict[str, List[str]],
        lock: threading.Lock,
    ) -> None:
        """Union node = ONE atomic commit over deterministic member order."""
        ctx_d = ctx.digest()
        ext_inputs = {}
        with lock:
            for m in group.members:
                for d in m.deps:
                    gid = member_to_group.get(d, d)
                    if gid != group.id and gid in outputs:
                        ext_inputs[d] = outputs[gid]
        in_d = payload_digest(ext_inputs)
        hit = self._lookup(group.id, ctx_d, in_d)
        if hit is not None:
            with lock:
                outputs[group.id] = hit.value
                resolved["replayed"].append(group.id)
            return
        ext_deps = sorted(
            {d for m in group.members for d in m.deps if member_to_group.get(d, d) != group.id}
        )
        member_out: Dict[str, Any] = {}
        # fixed-point style deterministic order: members sorted by id; a member
        # whose intra-group dep isn't ready yet sees the PREVIOUS iteration's
        # value (co-dependent semantics), seeded by its Ψ data or None.
        order = sorted(group.members, key=lambda n: n.id)
        seed = {m.id: dict(m.data).get("__seed__") for m in order}
        for m in order:
            inputs = {}
            for d in m.deps:
                gid = member_to_group.get(d, d)
                if gid == group.id:
                    inputs[m.kwarg_for(d)] = member_out.get(d, seed.get(d))
                else:
                    inputs[m.kwarg_for(d)] = ext_inputs.get(d)
            if m.fn is None:
                raise ValueError(f"union member {m.id!r} has no callable")
            v = m.fn(ctx, **inputs)
            member_out[m.id] = v.output if isinstance(v, WithContext) else v
        self._commit(
            group.id,
            ctx_d,
            in_d,
            member_out,
            0,
            meta={"members": [m.id for m in order]},
            deps=ext_deps,
        )
        with lock:
            outputs[group.id] = member_out
            resolved["executed"].append(group.id)


def _refuse_interrupt(nid: str, exc: Interrupted) -> NotImplementedError:
    return NotImplementedError(
        f"node {nid!r} reached the interrupt point {exc.name!r}: suspending a run at an "
        "interrupt point is not ported: ROADMAP Queue 1 item 14"
    )


@dataclass
class _Inflight:
    """Scheduler-side state of a node currently dispatched through the gateway."""

    node: Node
    ctx: Context
    ctx_digest: str
    input_digest: str
    inputs: Dict[str, Any]
    futures: List[Future] = field(default_factory=list)  # still-live attempts
    copies: int = 0  # total submissions ever made (speculation budget)
    attempts: int = 0  # gateway-level requeues observed (evictions, failures)
    expected: Optional[str] = None  # volatile: digest the result must match


class ClusterExecutor(_BaseExecutor):
    """Gateway-dispatched executor: barrier-free dependency-counted dataflow.

    Node.fn may be a string (registry task name) — required for remote
    dispatch — or a callable (executed gateway-side, e.g. reductions).

    Scheduling is event-driven, not staged: a node is dispatched the moment
    its last dependency commits (no toposort-level barriers), and completions
    are consumed from a condition-variable pump fed by future callbacks — the
    scheduler blocks in ``Condition.wait``, never in a sleep-poll loop.

    Straggler speculation is global rather than per-level: on every
    ``speculation_tick_s`` wakeup without completions, any inflight node whose
    elapsed time exceeds ``straggler.threshold × median`` of same-task
    completions gets a duplicate on another worker, up to ``max_copies``.
    The first completion wins; duplicates are idempotent by durable replay.

    Fault tolerance: when the gateway evicts a dead worker (heartbeat lost or
    system-level failure), in-flight requests are requeued on survivors and
    each requeue is journaled as a ``NODE_REQUEUE`` record carrying the
    attempt count.

    The reference's stream stages and its suspension at interrupt points are
    not copied (ROADMAP Queue 1 item 14): a graph cannot hold a stream node
    (``ContextGraph.add`` refuses it), and an interrupt raises
    ``NotImplementedError``.
    """

    def __init__(
        self,
        gateway: Gateway,
        speculative: bool = True,
        speculation_tick_s: float = 0.05,
        max_copies: int = 3,
        **kw,
    ):
        super().__init__(**kw)
        self.gateway = gateway
        self.speculative = speculative
        self.speculation_tick_s = speculation_tick_s
        self.max_copies = max_copies
        self.straggler = StragglerWatch()

    def run(
        self,
        graph: ContextGraph,
        run_meta: Optional[Mapping[str, Any]] = None,
    ) -> ExecutionReport:
        """Execute ``graph`` through the gateway; returns the run's report.

        ``run_meta`` is merged into the RUN_START record. A node that fails
        past its retry budget journals ``NODE_FAIL`` and its error propagates;
        no ``RUN_END`` is written.
        """
        t0 = time.monotonic()  # wall_s is a duration: clock steps must not skew it
        tracer = get_tracer()
        run_span = (
            tracer.start_span(f"run:{graph.name}", kind="run", attrs={"graph": graph.name})
            if tracer.enabled
            else None
        )
        _levels, exec_nodes, member_to_group = graph.schedule()  # validates DAG
        gdeps, deps_left, children = self._readiness(exec_nodes, member_to_group)
        run_token = f"{graph.name}#{next(_RUN_TOKENS)}"  # this run's requests

        outputs: Dict[str, Any] = {}
        out_ctx: Dict[str, Context] = {}
        resolved: Dict[str, List[str]] = {"replayed": [], "executed": []}
        replayed, executed = resolved["replayed"], resolved["executed"]
        ready = deque(sorted(nid for nid, c in deps_left.items() if c == 0))
        cv = threading.Condition()
        completions: deque = deque()  # (nid, Future) pairs, fed by callbacks
        inflight: Dict[str, _Inflight] = {}
        node_spans: Dict[str, Any] = {}  # open node spans, keyed like inflight

        if self.journal is not None:
            self.journal.append(
                JournalRecord(
                    kind="RUN_START",
                    node_id=graph.name,
                    meta={"nodes": len(exec_nodes), **dict(run_meta or {})},
                )
            )

        def pump(nid: str, fut: Future) -> None:
            # runs on gateway threads: hand the completion to the scheduler
            with cv:
                completions.append((nid, fut))
                cv.notify()

        def on_requeue(req: Any, reason: str) -> None:
            # gateway requeued one of our requests (eviction / worker failure);
            # requests of other runs/clients sharing the gateway chain through
            if req.meta.get("run") != run_token:
                if prev_requeue is not None:
                    prev_requeue(req, reason)
                return
            nid = req.meta.get("node", "")
            with cv:
                st = inflight.get(nid)
                if st is not None:
                    st.attempts += 1
            if st is not None and self.journal is not None:
                self.journal.append(
                    JournalRecord(
                        kind="NODE_REQUEUE",
                        node_id=nid,
                        attempt=req.attempts,
                        meta={"task": req.task_name, "reason": reason},
                    )
                )

        def done_count() -> int:
            return len(replayed) + len(executed)

        def finish(nid: str, value: Any, ctx: Context, status: str) -> None:
            outputs[nid] = value
            out_ctx[nid] = ctx
            resolved[status].append(nid)
            with cv:
                for c in children[nid]:
                    deps_left[c] -= 1
                    if deps_left[c] == 0:
                        ready.append(c)

        def dispatch(nid: str) -> None:
            node = exec_nodes[nid]
            if isinstance(node, UnionNode):
                raise NotImplementedError(
                    "union nodes execute locally; contract before remote dispatch"
                )
            parents = [out_ctx[d] for d in gdeps[nid]]
            ctx = Context.union_all(parents) if parents else graph.origin_context
            if node.data:
                ctx = ctx.with_data(node.data, origin=node.id)
            inputs = _inject_inputs(node, outputs, member_to_group)
            ctx_d, in_d = ctx.digest(), payload_digest(inputs)
            hit = self._lookup(nid, ctx_d, in_d)
            expected: Optional[str] = None
            if hit is not None:
                if hit.reexecute:
                    expected = hit.expected  # volatile: run again, verify
                else:
                    if hit.facts:
                        # re-emit journaled context facts so downstream ξ
                        # digests match the original run exactly
                        ctx = ctx.with_data(hit.facts, origin=nid)
                    finish(nid, hit.value, ctx, "replayed")
                    return
            if self.journal is not None:
                self.journal.append(
                    JournalRecord(
                        kind="NODE_START",
                        node_id=nid,
                        context_digest=ctx_d,
                        input_digest=in_d,
                    )
                )
            # the node span opens only after the replay probe missed — replayed
            # nodes emit zero spans, keeping span↔NODE_COMMIT 1:1
            span = (
                tracer.start_span(
                    nid,
                    parent=run_span,
                    kind="node",
                    attrs={"node": nid, "ctx": ctx_d, "in": in_d, "run": run_token},
                )
                if tracer.enabled
                else None
            )
            if callable(node.fn):
                fn_inputs = unwrap_digested(dict(inputs))
                attempt = 0
                while True:  # immediate retries: never sleep in the scheduler
                    try:
                        value = node.fn(ctx, **fn_inputs)
                        break
                    except Interrupted as exc:
                        if span is not None:
                            tracer.end(span, status="interrupt")
                        raise _refuse_interrupt(nid, exc) from exc
                    except Exception:
                        attempt += 1
                        if attempt > node.retry_limit(0):
                            if self.journal is not None:
                                self.journal.append(
                                    JournalRecord(
                                        kind="NODE_FAIL",
                                        node_id=nid,
                                        context_digest=ctx_d,
                                        input_digest=in_d,
                                        attempt=attempt,
                                    )
                                )
                                self.journal.flush()
                            if span is not None:
                                tracer.end(span, status="error", attrs={"attempts": attempt})
                            raise
                facts = dict(value.facts) if isinstance(value, WithContext) else None
                meta = {"facts": facts} if facts else None
                if isinstance(value, WithContext):
                    ctx = ctx.with_data(value.facts, origin=nid)
                    value = value.output
                self._commit(
                    nid,
                    ctx_d,
                    in_d,
                    value,
                    attempt,
                    meta=meta,
                    volatile=node.volatile,
                    expected=expected,
                    deps=node.deps,
                )
                if span is not None:
                    tracer.end(span, attrs={"attempts": attempt + 1})
                finish(nid, value, ctx, "executed")
                return
            # register BEFORE submit: a requeue can fire the instant the
            # gateway pops the request, and it must find the node inflight
            st = _Inflight(node, ctx, ctx_d, in_d, dict(inputs), expected=expected)
            with cv:
                inflight[nid] = st
                if span is not None:
                    node_spans[nid] = span
            self.straggler.started(str(node.fn), nid)
            fut = self.gateway.submit(
                str(node.fn),
                # the wire context carries the node span's identity as a
                # transient obs.* fact; st.ctx (and every commit/output
                # path) keeps the clean, digest-identical original
                inject_trace(ctx, span) if span is not None else ctx,
                inputs,
                affinity_key=str(node.resources.get("affinity", "")),
                meta={"node": nid, "run": run_token},
            )
            with cv:
                st.futures.append(fut)
                st.copies += 1
            fut.add_done_callback(lambda f, _n=nid: pump(_n, f))

        def speculate() -> None:
            with cv:
                candidates = [
                    (nid, st) for nid, st in inflight.items() if st.copies < self.max_copies
                ]
            for nid, st in candidates:
                if st.node.resources.get("affinity"):
                    # pinned to worker-held state: a copy elsewhere could be
                    # wrong, a copy on the holder is useless — don't race it
                    continue
                name = str(st.node.fn)
                if not self.straggler.should_speculate(name, nid, st.copies, self.max_copies):
                    continue
                with cv:
                    spec_span = node_spans.get(nid)
                dup = self.gateway.submit(
                    name,
                    # a speculative copy belongs to the same node span
                    inject_trace(st.ctx, spec_span) if spec_span is not None else st.ctx,
                    dict(st.inputs),
                    meta={"node": nid, "run": run_token, "speculative": True},
                )
                with cv:
                    st.futures.append(dup)
                    st.copies += 1
                dup.add_done_callback(lambda f, _n=nid: pump(_n, f))

        prev_requeue = self.gateway.on_requeue
        self.gateway.on_requeue = on_requeue
        try:
            total = len(exec_nodes)
            while done_count() < total:
                while True:
                    with cv:
                        nid = ready.popleft() if ready else None
                    if nid is None:
                        break
                    dispatch(nid)
                if done_count() >= total:
                    break
                with cv:
                    if not completions and not ready:
                        if not inflight:
                            left = total - done_count()
                            raise RuntimeError(
                                f"scheduler stalled: {left} nodes unfinished "
                                "with nothing in flight"
                            )
                        cv.wait(self.speculation_tick_s if self.speculative else None)
                    drained = []
                    while completions:
                        drained.append(completions.popleft())
                if not drained:
                    if self.speculative:
                        speculate()
                    continue
                for nid, fut in drained:
                    with cv:
                        st = inflight.get(nid)
                        stale = st is None or fut not in st.futures
                    if stale:
                        continue  # duplicate of an already-committed node
                    try:
                        value = fut.result()
                    except Interrupted as exc:
                        # a worker reached a named interrupt point
                        with cv:
                            inflight.pop(nid, None)
                            span = node_spans.pop(nid, None)
                        if span is not None:
                            tracer.end(span, status="interrupt")
                        self.straggler.finished(str(st.node.fn), nid)
                        raise _refuse_interrupt(nid, exc) from exc
                    except Exception:
                        with cv:
                            st.futures.remove(fut)
                            copies_left = len(st.futures)
                        if copies_left:
                            continue  # a speculative copy may still win
                        with cv:
                            del inflight[nid]
                            span = node_spans.pop(nid, None)
                        if span is not None:
                            tracer.end(span, status="error", attrs={"attempts": st.attempts})
                        self.straggler.finished(str(st.node.fn), nid)
                        if self.journal is not None:
                            self.journal.append(
                                JournalRecord(
                                    kind="NODE_FAIL",
                                    node_id=nid,
                                    context_digest=st.ctx_digest,
                                    input_digest=st.input_digest,
                                    attempt=st.attempts,
                                )
                            )
                            self.journal.flush()
                        raise
                    with cv:
                        copies = st.copies
                        requeues = st.attempts
                        del inflight[nid]
                        span = node_spans.pop(nid, None)
                    self.straggler.finished(str(st.node.fn), nid)
                    self._commit(
                        nid,
                        st.ctx_digest,
                        st.input_digest,
                        value,
                        requeues + copies - 1,
                        volatile=st.node.volatile,
                        expected=st.expected,
                        deps=st.node.deps,
                    )
                    if span is not None:
                        tracer.end(span, attrs={"copies": copies, "requeues": requeues})
                    finish(nid, value, st.ctx, "executed")
            if self.journal is not None:
                self.journal.append(JournalRecord(kind="RUN_END", node_id=graph.name))
                self.journal.flush()
        except BaseException:
            if self.journal is not None:
                self.journal.flush()
            if run_span is not None:
                tracer.end(run_span, status="error")
            raise
        finally:
            if self.gateway.on_requeue is on_requeue:  # don't clobber a later client
                self.gateway.on_requeue = prev_requeue
            with cv:
                inflight.clear()  # keep a dead chained handler's closure cheap
                node_spans.clear()
        if run_span is not None:
            tracer.end(run_span, attrs={"executed": len(executed), "replayed": len(replayed)})
        return ExecutionReport(
            outputs=outputs,
            contexts=out_ctx,
            replayed=tuple(replayed),
            executed=tuple(executed),
            wall_s=time.monotonic() - t0,
        )
