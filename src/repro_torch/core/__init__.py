"""SerPyTor core for the port: the context-aware durable graph execution the trainer
runs on, and the gateway and workers that serve.

Copies of the JAX-free modules of ``repro.core`` (the port imports nothing of
``repro``): ``context``, ``graph``, ``durable`` (journal and replay oracle,
``Interrupted``), ``executor`` (``LocalExecutor``, ``ClusterExecutor``), ``failure``
(``RetryPolicy``, ``StragglerWatch``), ``heartbeat``, ``server``
(``TaskRegistry``, the in-process and HTTP workers) and ``gateway``
(``Gateway`` and its allocators). Their journals, digests, wire frames and
replay semantics are the reference's, so each package reads and replays the
other's journals and each package's client runs tasks on the other's
workers. What was left out is named in each module and in ROADMAP.md: the
replay-safety lint (Queue 1 item 12), streams, caches, compaction and
interrupt points (item 14), and the asyncio runtime ``core/aio`` (item 15).
"""

from .context import EMPTY_CONTEXT, Context, ContextEntry
from .durable import KNOWN_KINDS, Interrupted, Journal, JournalRecord, ReplayCache
from .executor import ClusterExecutor, ExecutionReport, LocalExecutor, WithContext
from .failure import FailureKind, RetryPolicy, StragglerWatch
from .gateway import (
    AllocationError,
    Gateway,
    TaskCancelled,
    TaskRequest,
    WorkerHandle,
    context_affinity,
    least_loaded,
    power_of_two,
    round_robin,
)
from .graph import ContextGraph, CycleError, Node, UnionNode, fn_digest, toposort_levels
from .heartbeat import HeartbeatServer, check_heartbeat, telemetry
from .server import (
    FlakyWorker,
    InProcWorker,
    TaskRegistry,
    WorkerClient,
    WorkerServer,
    WorkerStreamError,
)

__all__ = [
    "Context",
    "ContextEntry",
    "EMPTY_CONTEXT",
    "Journal",
    "JournalRecord",
    "KNOWN_KINDS",
    "ReplayCache",
    "LocalExecutor",
    "ClusterExecutor",
    "ExecutionReport",
    "WithContext",
    "FailureKind",
    "RetryPolicy",
    "StragglerWatch",
    "ContextGraph",
    "CycleError",
    "Node",
    "UnionNode",
    "fn_digest",
    "toposort_levels",
    "HeartbeatServer",
    "check_heartbeat",
    "telemetry",
    "Interrupted",
    "TaskRegistry",
    "WorkerServer",
    "WorkerClient",
    "InProcWorker",
    "FlakyWorker",
    "WorkerStreamError",
    "Gateway",
    "TaskRequest",
    "WorkerHandle",
    "AllocationError",
    "TaskCancelled",
    "round_robin",
    "least_loaded",
    "power_of_two",
    "context_affinity",
]
