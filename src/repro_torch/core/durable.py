"""Durable execution (§4.2): the write-ahead journal and the replay oracle, a copy of
``repro.core.durable``.

A run of a ContextGraph is journaled as an append-only event log. Each
committed node records:

    (node_id, context_digest, input_digest, output_digest, payload-or-ref)

Replaying a run re-executes the graph but *skips* any node whose
(context_digest, input_digest) matches a committed entry, re-injecting the
recorded output — effectively-once semantics on top of at-least-once retries.
Large payloads (model/optimizer state) are stored by reference: the journal
holds a ``ref`` string resolved by the checkpoint store, never raw tensors.

The journal format is the reference's (docs/journal-format.md):
length-prefixed msgpack records with a crc32 per record and
tagged-compression bodies, so each package reads the other's journals. Torn
tails (a crash mid-append) are detected and truncated on open.

Not copied: journal compaction (a ``SNAPSHOT`` record) and the stream-chunk
records (``CHUNK_COMMIT``, ``STREAM_EOS``), which wait for ROADMAP Queue 1
item 14: a journal holding one raises when it is read. Nor are the
``interrupt()`` points, lineage headers and the fork bookkeeping of durable
workflows: only the ``Interrupted`` exception is here, which the worker and
the gateway (``core/server.py``, ``core/gateway.py``) carry across as a
status.
"""

from __future__ import annotations

import binascii
import os
import struct
import threading
import time
import warnings
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

from repro_torch.wire import decode_payload, encode_payload

__all__ = ["Interrupted", "Journal", "JournalRecord", "ReplayCache", "KNOWN_KINDS"]

_HEADER = struct.Struct("<II")  # (length, crc32)

#: Every record kind the reference's reader interprets. Kinds outside this
#: set are *tolerated* (docs/journal-format.md §5): ``records()`` skips them
#: with a warning, so a journal written by a newer writer stays readable.
KNOWN_KINDS = frozenset(
    {
        "RUN_START",
        "NODE_START",
        "NODE_COMMIT",
        "NODE_REQUEUE",
        "CHUNK_COMMIT",
        "STREAM_EOS",
        "CACHE_HIT",
        "CACHE_STORE",
        "NODE_FAIL",
        "RUN_END",
        "CKPT",
        "SUSPEND",
        "RESUME",
        "FORK",
        "LINEAGE",
        "GW_HANDOFF",
        "SNAPSHOT",
    }
)

#: Known kinds whose meaning the port does not carry yet: reading one raises.
NOT_PORTED_KINDS = frozenset({"SNAPSHOT", "CHUNK_COMMIT", "STREAM_EOS"})


class Interrupted(Exception):
    """A task reached a named interrupt point without an answer in its ξ.

    Executors treat it as a *suspension request*, not a failure; a worker
    reports it as ``status: interrupt`` and the gateway fails the request's
    future with it, never retrying it. The ``interrupt()`` points that raise
    it and the executor's suspension wait for ROADMAP Queue 1 item 14.
    """

    def __init__(self, name: str, payload: Any = None):
        super().__init__(name)
        self.name = name
        self.payload = payload


@dataclass
class JournalRecord:
    """One journal event — see docs/journal-format.md §2 for the field contract."""

    kind: str  # RUN_START | NODE_START | NODE_COMMIT | NODE_REQUEUE
    #          # | CHUNK_COMMIT | STREAM_EOS (chunk-granular streams)
    #          # | CACHE_HIT | CACHE_STORE | NODE_FAIL | RUN_END | CKPT
    #          # | SUSPEND | RESUME | FORK | LINEAGE (durable workflows)
    node_id: str = ""
    context_digest: str = ""
    input_digest: str = ""
    output_digest: str = ""
    payload: Any = None  # inline output (small) — mutually exclusive with ref
    ref: str = ""  # checkpoint-store reference for large outputs
    wall_time: float = 0.0
    attempt: int = 0
    meta: Dict[str, Any] = field(default_factory=dict)

    def to_obj(self) -> dict:
        return {
            "k": self.kind,
            "n": self.node_id,
            "c": self.context_digest,
            "i": self.input_digest,
            "o": self.output_digest,
            "p": self.payload,
            "r": self.ref,
            "t": self.wall_time,
            "a": self.attempt,
            "m": self.meta,
        }

    @staticmethod
    def from_obj(o: Mapping) -> "JournalRecord":
        """Decode one record object — forward-compatibly.

        Missing fields default (a future writer may drop one) and unknown
        keys are ignored (a future writer may add one), so a pre-upgrade
        reader never raises on records written by a newer version — the
        forward-compat contract of docs/journal-format.md §5.
        """
        return JournalRecord(
            kind=str(o.get("k", "")),
            node_id=o.get("n", ""),
            context_digest=o.get("c", ""),
            input_digest=o.get("i", ""),
            output_digest=o.get("o", ""),
            payload=o.get("p"),
            ref=o.get("r", ""),
            wall_time=o.get("t", 0.0),
            attempt=o.get("a", 0),
            meta=dict(o.get("m") or {}),
        )


class Journal:
    """Append-only, crash-safe event log. Thread-safe appends.

    ``sync`` policy: "always" fsyncs per commit (paper-faithful durable mode),
    "batch" fsyncs on flush()/close(), "never" for in-memory tests.
    """

    def __init__(self, path: str, sync: str = "always"):
        assert sync in ("always", "batch", "never")
        self.path = path
        self.sync = sync
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._recover_tail()
        self._fh = open(path, "ab")

    # -- crash recovery ------------------------------------------------------
    def _recover_tail(self) -> None:
        """Truncate a torn tail record (partial append at crash time)."""
        if not os.path.exists(self.path):
            return
        good = 0
        with open(self.path, "rb") as fh:
            data = fh.read()
        off = 0
        while off + _HEADER.size <= len(data):
            length, crc = _HEADER.unpack_from(data, off)
            body = data[off + _HEADER.size : off + _HEADER.size + length]
            if len(body) < length or binascii.crc32(body) != crc:
                break
            off += _HEADER.size + length
            good = off
        if good != len(data):
            with open(self.path, "r+b") as fh:
                fh.truncate(good)

    # -- append ----------------------------------------------------------------
    def append(self, rec: JournalRecord) -> None:
        rec.wall_time = rec.wall_time or time.time()  # record timestamp
        body = encode_payload(rec.to_obj())
        frame = _HEADER.pack(len(body), binascii.crc32(body)) + body
        with self._lock:
            self._fh.write(frame)
            if self.sync == "always":
                self._fh.flush()
                os.fsync(self._fh.fileno())

    def flush(self) -> None:
        with self._lock:
            self._fh.flush()
            if self.sync != "never":
                os.fsync(self._fh.fileno())

    def close(self) -> None:
        self.flush()
        self._fh.close()

    def kinds(self) -> Dict[str, int]:
        """Histogram of record kinds — cheap integrity/debug view of a run.

        E.g. a trainer's round reads as RUN_START=1, NODE_START=n,
        NODE_COMMIT=n, CKPT=1, RUN_END=1.
        """
        return dict(Counter(rec.kind for rec in self.records()))

    def records(self) -> Iterator[JournalRecord]:
        """Yield every committed record, in append order.

        A checksum-valid frame whose body nonetheless fails to decode, or
        whose kind is unknown, is skipped with a warning, never raised
        (format §5). A record of a kind in :data:`NOT_PORTED_KINDS` raises.
        """
        with open(self.path, "rb") as fh:
            data = fh.read()
        off = 0
        while off + _HEADER.size <= len(data):
            length, crc = _HEADER.unpack_from(data, off)
            body = data[off + _HEADER.size : off + _HEADER.size + length]
            if len(body) < length or binascii.crc32(body) != crc:
                break
            off += _HEADER.size + length
            try:
                rec = JournalRecord.from_obj(decode_payload(body))
            except Exception as exc:
                warnings.warn(
                    f"journal {self.path}: skipping undecodable record at "
                    f"offset {off - _HEADER.size - length} ({exc})",
                    RuntimeWarning,
                    stacklevel=2,
                )
                continue
            if rec.kind not in KNOWN_KINDS:
                warnings.warn(
                    f"journal {self.path}: skipping record of unknown kind "
                    f"{rec.kind!r} at offset {off - _HEADER.size - length}",
                    RuntimeWarning,
                    stacklevel=2,
                )
                continue
            if rec.kind in NOT_PORTED_KINDS:
                raise NotImplementedError(
                    f"journal {self.path}: a {rec.kind} record (journal compaction or a "
                    "stream) is not ported: ROADMAP Queue 1 item 14"
                )
            yield rec

    def __enter__(self) -> "Journal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ReplayCache:
    """Index of committed node outputs from a journal — the replay oracle."""

    def __init__(self, journal: Optional[Journal] = None):
        self._committed: Dict[Tuple[str, str, str], JournalRecord] = {}
        self.stats = {"commits": 0, "replayed": 0, "scanned": 0}
        if journal is not None and os.path.exists(journal.path):
            for rec in journal.records():
                self.stats["scanned"] += 1
                if rec.kind == "NODE_COMMIT":
                    key = (rec.node_id, rec.context_digest, rec.input_digest)
                    self._committed[key] = rec
                    self.stats["commits"] += 1

    def lookup(
        self, node_id: str, context_digest: str, input_digest: str
    ) -> Optional[JournalRecord]:
        rec = self._committed.get((node_id, context_digest, input_digest))
        if rec is not None:
            self.stats["replayed"] += 1
        return rec

    def record(self, rec: JournalRecord) -> None:
        self._committed[(rec.node_id, rec.context_digest, rec.input_digest)] = rec
