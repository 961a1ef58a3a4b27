"""SerPyTor core for the port: the context-aware durable graph execution the trainer runs on.

Copies of the JAX-free modules of ``repro.core`` that ``train/trainer.py``
reaches (the port imports nothing of ``repro``): ``context``, ``graph``,
``durable`` (journal and replay oracle), ``executor`` (``LocalExecutor``),
``failure`` (``RetryPolicy``, ``StragglerWatch``) and ``heartbeat``. Their
journals, digests and replay semantics are the reference's, so each package
reads and replays the other's journals. What was left out is named in each
module and in ROADMAP.md (Queue 1 items 3, 12 and 14).
"""

from .context import EMPTY_CONTEXT, Context, ContextEntry
from .durable import KNOWN_KINDS, Journal, JournalRecord, ReplayCache
from .executor import ExecutionReport, LocalExecutor, WithContext
from .failure import FailureKind, RetryPolicy, StragglerWatch
from .graph import ContextGraph, CycleError, Node, UnionNode, fn_digest, toposort_levels
from .heartbeat import HeartbeatServer, check_heartbeat, telemetry

__all__ = [
    "Context",
    "ContextEntry",
    "EMPTY_CONTEXT",
    "Journal",
    "JournalRecord",
    "KNOWN_KINDS",
    "ReplayCache",
    "LocalExecutor",
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
]
