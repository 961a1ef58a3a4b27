"""ContextGraph: the context-aware computational graph of SerPyTor §4.1, a copy of
``repro.core.graph``.

Nodes are atomic tasks (dependency-injected callables) carrying data Ψ.
Edges are dependencies. Co-dependent nodes (strongly connected components —
the paper's "union nodes" A') are contracted before scheduling so the
executable graph is a DAG, per §4.1.1.

Context propagation follows the paper exactly:
  - the root inherits the origin context ξ(∅) plus its own Ψ,
  - a node with independent origins inherits the union of its parents' ξ,
  - a union node's ξ is the union of the ξ and Ψ of every member.

Not copied, and refused where a caller asks for them: stream nodes
(``stream=``, ``add_stream``) and named interrupt points, which wait for
ROADMAP Queue 1 item 14, and the registration-time replay-safety lint
(``check=`` or ``REPRO_LINT`` other than ``"off"``), which waits for item 12.
"""

from __future__ import annotations

import hashlib
import itertools
import os
from dataclasses import dataclass, field
from types import CodeType, ModuleType
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from repro_torch.wire import DIGEST_HEX_LEN, canonical_bytes

from .context import EMPTY_CONTEXT, Context

__all__ = [
    "Node",
    "UnionNode",
    "ContextGraph",
    "CycleError",
    "fn_digest",
    "toposort_levels",
]

# Closure cells holding values that are neither callable nor canonically
# serializable get a process-unique marker: such functions simply never hit
# the result cache (a miss, never a stale value from mutated captured state).
_OPAQUE_CELLS = itertools.count()


def _feed_code(h: "hashlib._Hash", code: CodeType, seen: set) -> None:
    """Hash a code object structurally — never via repr, which embeds
    memory addresses for nested code objects (lambdas, comprehensions) and
    would fork the digest on every process."""
    h.update(code.co_code)
    h.update(repr(code.co_names).encode())
    for const in code.co_consts:
        if isinstance(const, CodeType):
            h.update(b"<code>")
            _feed_code(h, const, seen)
        else:
            h.update(repr(const).encode())


def _feed_value(h: "hashlib._Hash", value: Any, seen: set) -> None:
    """Hash a captured value: callables recurse, modules hash by name,
    serializable values hash by content, anything else is opaque (unique
    marker — defeats caching)."""
    if isinstance(value, ModuleType):  # locally-imported modules are common cells
        h.update(b"mod:" + value.__name__.encode())
        return
    if callable(value):
        h.update(b"fn:")
        _feed_fn(h, value, seen)
        return
    try:
        h.update(b"val:" + canonical_bytes(value))
    except TypeError:
        h.update(f"opaque:{next(_OPAQUE_CELLS)}".encode())


def _feed_fn(h: "hashlib._Hash", fn: Any, seen: set) -> None:
    if id(fn) in seen:  # mutually-recursive closures terminate deterministically
        h.update(b"cycle:")
        return
    seen.add(id(fn))
    target = fn
    while hasattr(target, "__wrapped__"):
        target = target.__wrapped__
    seen.add(id(target))
    code = getattr(target, "__code__", None)
    if code is None:
        name = getattr(target, "__qualname__", None) or type(target).__qualname__
        mod = getattr(target, "__module__", None) or type(target).__module__
        h.update(f"obj:{mod}:{name}".encode())
        return
    h.update(b"code:")
    h.update(getattr(target, "__qualname__", "").encode())
    _feed_code(h, code, seen)
    for default in getattr(target, "__defaults__", None) or ():
        h.update(b"default:")
        _feed_value(h, default, seen)
    for cell in getattr(target, "__closure__", None) or ():
        try:
            captured = cell.cell_contents
        except ValueError:  # empty cell (still being defined)
            h.update(b"cell:empty")
            continue
        h.update(b"cell:")
        _feed_value(h, captured, seen)


def fn_digest(fn: "Callable[..., Any] | str | None") -> str:
    """Deterministic identity of a task implementation — the cache key's first leg.

    Registry task names (string ``fn``) digest by name: the deployment owns
    versioning of named tasks (bump the name, or fold a version fact into the
    context, when semantics change). Python callables digest by *code*:
    qualname, bytecode, names, consts (nested code objects hashed
    structurally, so lambdas/comprehensions stay process-stable), defaults,
    and closure cells — captured callables recurse (cycle-safe), captured
    serializable values hash by canonical content, and anything opaque gets
    a unique marker so the function never hits the cache rather than risking
    a stale hit on mutated captured state. Callables without a code object
    (builtins, callable instances) digest by module-qualified name only —
    instance state is NOT captured; see docs/result-cache.md §3.
    """
    h = hashlib.sha256()
    if fn is None:
        h.update(b"none:")
    elif isinstance(fn, str):
        h.update(b"task:" + fn.encode())
    else:
        _feed_fn(h, fn, set())
    return h.hexdigest()[:DIGEST_HEX_LEN]


class CycleError(ValueError):
    """Raised when a cycle survives contraction (contract=False paths)."""


@dataclass
class Node:
    """An atomic task.

    ``fn`` receives its inputs purely by injection: ``fn(ctx, **inputs)`` where
    ``inputs`` maps each dependency's node id (or alias) to that node's output.
    ``data`` is Ψ(node): static facts folded into the node's context.

    ``volatile`` marks a node whose output is large transient data: its
    commit records only the output *digest* (``payload=None``), it is never
    replay-skipped (re-execution is the recovery path), and a re-execution
    that disagrees with the journaled digest is a hard non-determinism error.

    ``retries`` is the per-node retry budget: ``None`` (default) defers to
    the executor's :class:`~repro_torch.core.failure.RetryPolicy`; an explicit
    integer — including 0 — is exact. Stateful tasks whose inputs are
    consumed by execution (buffers updated in place) must set ``retries=0``.
    """

    id: str
    fn: Optional[Callable[..., Any]] = None
    deps: Tuple[str, ...] = ()
    data: Mapping[str, Any] = field(default_factory=dict)
    aliases: Mapping[str, str] = field(default_factory=dict)  # dep id -> kwarg name
    resources: Mapping[str, float] = field(default_factory=dict)  # scheduling hints
    retries: Optional[int] = None  # None ⇒ executor policy; explicit int is exact
    timeout_s: Optional[float] = None
    volatile: bool = False  # digest-only commits, re-execute-and-verify replay

    def kwarg_for(self, dep_id: str) -> str:
        """Kwarg name a dependency's output is injected under (alias-aware)."""
        return self.aliases.get(dep_id, dep_id)

    def retry_limit(self, default: int = 0) -> int:
        """Effective retry budget: the node's explicit one, else ``default``."""
        return self.retries if self.retries is not None else default

    def fn_digest(self) -> str:
        """Memoized :func:`fn_digest` of this node's callable / task name."""
        d = getattr(self, "_fn_digest", None)
        if d is None:
            d = fn_digest(self.fn)
            self._fn_digest = d
        return d


@dataclass
class UnionNode:
    """A contracted SCC — the paper's A' union node."""

    id: str
    members: Tuple[Node, ...]
    deps: Tuple[str, ...] = ()

    @property
    def data(self) -> Dict[str, Any]:
        """Merged Ψ of all members (deterministic member-id order)."""
        merged: Dict[str, Any] = {}
        for m in sorted(self.members, key=lambda n: n.id):
            merged.update(m.data)
        return merged

    def fn_digest(self) -> str:
        """Combined fn digest: members' (id, fn) pairs in deterministic order."""
        d = getattr(self, "_fn_digest", None)
        if d is None:
            h = hashlib.sha256()
            for m in sorted(self.members, key=lambda n: n.id):
                h.update(m.id.encode())
                h.update(b"\x00")
                h.update(m.fn_digest().encode())
                h.update(b"\n")
            d = h.hexdigest()[:DIGEST_HEX_LEN]
            self._fn_digest = d
        return d


def _tarjan_scc(ids: Sequence[str], deps_of: Mapping[str, Sequence[str]]) -> List[List[str]]:
    """Iterative Tarjan SCC (no recursion limit issues on big graphs)."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Dict[str, bool] = {}
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]

    for root in ids:
        if root in index:
            continue
        work: List[Tuple[str, int]] = [(root, 0)]
        while work:
            v, pi = work.pop()
            if pi == 0:
                index[v] = low[v] = counter[0]
                counter[0] += 1
                stack.append(v)
                on_stack[v] = True
            recurse = False
            children = [d for d in deps_of.get(v, ()) if d in deps_of or d in index]
            for i in range(pi, len(children)):
                w = children[i]
                if w not in index:
                    work.append((v, i + 1))
                    work.append((w, 0))
                    recurse = True
                    break
                elif on_stack.get(w, False):
                    low[v] = min(low[v], index[w])
            if recurse:
                continue
            if low[v] == index[v]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    scc.append(w)
                    if w == v:
                        break
                sccs.append(sorted(scc))
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[v])
    return sccs


def toposort_levels(
    ids: Sequence[str], deps_of: Mapping[str, Sequence[str]]
) -> List[List[str]]:
    """Kahn levels: each level's nodes are mutually independent (parallelizable)."""
    indeg = {i: 0 for i in ids}
    children: Dict[str, List[str]] = {i: [] for i in ids}
    for i in ids:
        for d in deps_of.get(i, ()):
            if d in indeg:
                indeg[i] += 1
                children[d].append(i)
    frontier = sorted(i for i, d in indeg.items() if d == 0)
    levels: List[List[str]] = []
    seen = 0
    while frontier:
        levels.append(frontier)
        nxt: List[str] = []
        for i in frontier:
            seen += 1
            for c in children[i]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    nxt.append(c)
        frontier = sorted(nxt)
    if seen != len(list(ids)):
        raise CycleError("graph has a cycle that was not contracted")
    return levels


class ContextGraph:
    """A context-aware computational graph (builds, contracts, schedules)."""

    def __init__(self, origin: Context = EMPTY_CONTEXT, name: str = "graph"):
        self.name = name
        self.origin_context = origin
        self.nodes: Dict[str, Node] = {}

    # -- building ----------------------------------------------------------
    def add(
        self,
        id: str,
        fn: Optional[Callable[..., Any]] = None,
        *,
        deps: Iterable[str] = (),
        data: Optional[Mapping[str, Any]] = None,
        aliases: Optional[Mapping[str, str]] = None,
        resources: Optional[Mapping[str, float]] = None,
        retries: Optional[int] = None,
        timeout_s: Optional[float] = None,
        stream: str = "",
        volatile: bool = False,
        check: Optional[str] = None,
    ) -> Node:
        if id in self.nodes:
            raise ValueError(f"duplicate node id {id!r}")
        check_mode = check if check is not None else os.environ.get("REPRO_LINT", "off")
        if check_mode not in ("off", "warn", "error"):
            raise ValueError(
                f"node {id!r}: check must be 'off', 'warn', or 'error', not {check_mode!r}"
            )
        if check_mode != "off":
            raise NotImplementedError(
                f"node {id!r}: the replay-safety lint (check={check_mode!r}) is not ported: "
                "ROADMAP Queue 1 item 12"
            )
        if stream:
            raise NotImplementedError(
                f"node {id!r}: stream nodes are not ported: ROADMAP Queue 1 item 14"
            )
        node = Node(
            id=id,
            fn=fn,
            deps=tuple(deps),
            data=dict(data or {}),
            aliases=dict(aliases or {}),
            resources=dict(resources or {}),
            retries=retries,
            timeout_s=timeout_s,
            volatile=volatile,
        )
        self.nodes[id] = node
        return node

    def task(self, id: str, *, deps: Iterable[str] = (), **kw):
        """Decorator form: ``@graph.task("loss", deps=["fwd"])``."""

        def wrap(fn: Callable[..., Any]) -> Callable[..., Any]:
            self.add(id, fn, deps=deps, **kw)
            return fn

        return wrap

    def validate(self) -> None:
        for n in self.nodes.values():
            for d in n.deps:
                if d not in self.nodes:
                    raise KeyError(f"node {n.id!r} depends on unknown node {d!r}")

    # -- contraction (§4.1 union nodes) -------------------------------------
    def contract(self) -> Tuple[Dict[str, "UnionNode | Node"], Dict[str, str]]:
        """Contract SCCs into union nodes.

        Returns (exec_nodes, member_to_group): exec_nodes is a DAG keyed by
        group id; member_to_group maps original ids to their group id.
        """
        self.validate()
        deps_of = {i: n.deps for i, n in self.nodes.items()}
        sccs = _tarjan_scc(sorted(self.nodes), deps_of)
        member_to_group: Dict[str, str] = {}
        exec_nodes: Dict[str, UnionNode | Node] = {}
        for scc in sccs:
            if len(scc) == 1 and scc[0] not in self.nodes[scc[0]].deps:
                member_to_group[scc[0]] = scc[0]
            else:
                gid = "∪(" + "+".join(scc) + ")"
                for m in scc:
                    member_to_group[m] = gid
        for scc in sccs:
            gid = member_to_group[scc[0]]
            ext = sorted(
                {
                    member_to_group[d]
                    for m in scc
                    for d in self.nodes[m].deps
                    if member_to_group[d] != gid
                }
            )
            if gid == scc[0] and len(scc) == 1:
                # keep the ORIGINAL node (original deps are needed for
                # dependency injection of specific union-node members)
                exec_nodes[gid] = self.nodes[scc[0]]
            else:
                exec_nodes[gid] = UnionNode(
                    id=gid, members=tuple(self.nodes[m] for m in scc), deps=tuple(ext)
                )
        return exec_nodes, member_to_group

    @staticmethod
    def group_deps(
        exec_nodes: Mapping[str, "UnionNode | Node"],
        member_to_group: Mapping[str, str],
    ) -> Dict[str, Tuple[str, ...]]:
        """Scheduling-level deps: original deps mapped through contraction."""
        out: Dict[str, Tuple[str, ...]] = {}
        for gid, node in exec_nodes.items():
            if isinstance(node, UnionNode):
                out[gid] = node.deps  # already external group ids
            else:
                out[gid] = tuple(
                    sorted(
                        {
                            member_to_group.get(d, d)
                            for d in node.deps
                            if member_to_group.get(d, d) != gid
                        }
                    )
                )
        return out

    # -- context propagation -------------------------------------------------
    def propagate_contexts(
        self,
        exec_nodes: Optional[Mapping[str, "UnionNode | Node"]] = None,
    ) -> Dict[str, Context]:
        """Compute ξ for every exec node per the §4.1 rules (no execution)."""
        if exec_nodes is None:
            exec_nodes, member_to_group = self.contract()
        else:
            _, member_to_group = self.contract()
        deps_of = self.group_deps(exec_nodes, member_to_group)
        levels = toposort_levels(sorted(exec_nodes), deps_of)
        xi: Dict[str, Context] = {}
        for level in levels:
            for nid in level:
                node = exec_nodes[nid]
                parents = [xi[d] for d in deps_of[nid]]
                if parents:
                    inherited = Context.union_all(parents)
                else:
                    inherited = self.origin_context  # ξ(∅)
                if isinstance(node, UnionNode):
                    # ξ(A') = ⋃ ξ(member-parents) ∪ ⋃ Ψ(member)
                    ctx = inherited
                    for m in sorted(node.members, key=lambda n: n.id):
                        ctx = ctx.with_data(m.data, origin=m.id) if m.data else ctx
                else:
                    ctx = (
                        inherited.with_data(node.data, origin=node.id)
                        if node.data
                        else inherited
                    )
                xi[nid] = ctx
        return xi

    def schedule(self) -> Tuple[List[List[str]], Dict[str, "UnionNode | Node"], Dict[str, str]]:
        """(levels, exec_nodes, member_to_group) — ready for an executor."""
        exec_nodes, member_to_group = self.contract()
        deps_of = self.group_deps(exec_nodes, member_to_group)
        levels = toposort_levels(sorted(exec_nodes), deps_of)
        return levels, exec_nodes, member_to_group

    def __len__(self) -> int:
        return len(self.nodes)
