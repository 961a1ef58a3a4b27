"""Context: the ξ of SerPyTor §4.1, a copy of ``repro.core.context``.

A context is a *set of provenance-tagged facts*. The paper defines context
propagation as set union:

    ξ(R)  = ξ(∅) ∪ Ψ(R)                      (root)
    ξ(n)  = ⋃_{p ∈ origins(n)} ξ(p) ∪ Ψ(n)   (independent origins)
    ξ(A') = ξ(A) ∪ ξ(B) ∪ Ψ(A) ∪ Ψ(B)        (union node for co-dependent origins)

A Context is an immutable frozenset of ``ContextEntry`` facts keyed by (key,
origin, lamport). Union never drops or overwrites a fact; ``get`` resolves a
key to the *latest* fact (max lamport, ties broken by origin ordering),
which gives deterministic reads on replay.

Every value is canonically serialized through ``repro_torch.wire``, whose
canonical bytes are the reference's: a context built from the same facts
has the same digest in both packages (``tests/test_torch_core.py``), so the
port's journal records carry the reference's context digests.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Iterable, Iterator, Mapping, Optional, Tuple

from repro_torch.wire import DIGEST_HEX_LEN, canonical_bytes, canonical_digest, from_canonical

__all__ = [
    "ContextEntry",
    "Context",
    "EMPTY_CONTEXT",
    "OBS_KEY_PREFIX",
    "canonical_digest",
]

#: Reserved key namespace for observability facts (trace identity etc.).
#: Facts under this prefix are *transport-only*: they ride the wire context
#: but are excluded from :meth:`Context.digest`, so tracing never perturbs
#: replay identity or cache keys. Injectors must stamp them with lamport 0
#: so ``max_lamport()`` — and hence every later real fact's lamport — is
#: unchanged between traced and untraced runs.
OBS_KEY_PREFIX = "obs."


@dataclass(frozen=True, order=True)
class ContextEntry:
    """A single provenance-tagged fact.

    ``lamport`` orders facts causally: a node writing a fact stamps it with
    1 + max(lamport of every inherited fact). ``origin`` is the id of the node
    (or external source) that produced the fact.

    ``value_json`` is the wire canonical form, computed once at construction —
    entries are immutable, so it doubles as a per-entry serialization cache;
    ``digest`` memoizes the per-entry hash the set digest is built from.
    """

    key: str
    origin: str
    lamport: int
    value_json: bytes  # canonical encoding — hashable, deterministic
    _digest: Optional[str] = field(default=None, compare=False, repr=False)

    @property
    def value(self) -> Any:
        return from_canonical(self.value_json)

    @property
    def digest(self) -> str:
        """Memoized per-entry digest (entries are frozen, so compute once)."""
        if self._digest is None:
            h = hashlib.sha256()
            h.update(self.key.encode())
            h.update(b"\x00")
            h.update(self.origin.encode())
            h.update(b"\x00")
            h.update(str(self.lamport).encode())
            h.update(b"\x00")
            h.update(self.value_json)
            object.__setattr__(self, "_digest", h.hexdigest()[:DIGEST_HEX_LEN])
        return self._digest

    @staticmethod
    def make(key: str, value: Any, origin: str, lamport: int = 0) -> "ContextEntry":
        return ContextEntry(
            key=key, origin=origin, lamport=lamport, value_json=canonical_bytes(value)
        )


class Context:
    """Immutable set of ContextEntry facts with ξ-union semantics."""

    __slots__ = ("_entries", "_digest")

    def __init__(self, entries: Iterable[ContextEntry] = ()):  # noqa: D401
        self._entries: frozenset[ContextEntry] = frozenset(entries)
        self._digest: Optional[str] = None

    # -- construction -----------------------------------------------------
    @staticmethod
    def origin(data: Mapping[str, Any], origin: str = "∅") -> "Context":
        """Origin context ξ(∅): environment supplied before computation starts."""
        return Context(ContextEntry.make(k, v, origin, 0) for k, v in data.items())

    def with_data(self, data: Mapping[str, Any], origin: str) -> "Context":
        """ξ ∪ Ψ(node): fold a node's own data Ψ into the context."""
        lam = self.max_lamport() + 1
        new = [ContextEntry.make(k, v, origin, lam) for k, v in data.items()]
        return Context(self._entries.union(new))

    # -- the paper's union operator ---------------------------------------
    def union(self, *others: "Context") -> "Context":
        entries = self._entries
        for o in others:
            entries = entries.union(o._entries)
        return Context(entries)

    __or__ = union

    @staticmethod
    def union_all(contexts: Iterable["Context"]) -> "Context":
        acc: frozenset[ContextEntry] = frozenset()
        for c in contexts:
            acc = acc.union(c._entries)
        return Context(acc)

    # -- reads -------------------------------------------------------------
    def get(self, key: str, default: Any = None) -> Any:
        """Deterministic resolution: latest lamport wins; ties by origin sort."""
        best: Optional[ContextEntry] = None
        for e in self._entries:
            if e.key != key:
                continue
            if best is None or (e.lamport, e.origin) > (best.lamport, best.origin):
                best = e
        return best.value if best is not None else default

    def get_all(self, key: str) -> Tuple[Any, ...]:
        """All facts for a key, causally ordered (provenance-preserving read)."""
        es = sorted(
            (e for e in self._entries if e.key == key),
            key=lambda e: (e.lamport, e.origin),
        )
        return tuple(e.value for e in es)

    def provenance(self, key: str) -> Tuple[str, ...]:
        es = sorted(
            (e for e in self._entries if e.key == key),
            key=lambda e: (e.lamport, e.origin),
        )
        return tuple(e.origin for e in es)

    def origins(self) -> frozenset:
        return frozenset(e.origin for e in self._entries)

    def keys(self) -> frozenset:
        return frozenset(e.key for e in self._entries)

    def max_lamport(self) -> int:
        return max((e.lamport for e in self._entries), default=0)

    def as_dict(self) -> dict:
        """Resolved view (latest fact per key)."""
        return {k: self.get(k) for k in self.keys()}

    # -- identity ----------------------------------------------------------
    def digest(self) -> str:
        """Stable digest of the full fact set (not just the resolved view).

        Combines the memoized per-entry digests in sorted order, so after a
        union only the 16-hex-char entry digests are hashed — no value is
        re-serialized (the context-union hot path; see benchmarks/wire_bench.py
        and docs/journal-format.md §4 for the exact algorithm). Facts under
        :data:`OBS_KEY_PREFIX` are transport-only metadata and are excluded,
        so replay identity is independent of tracing.
        """
        if self._digest is None:
            h = hashlib.sha256()
            for d in sorted(
                e.digest for e in self._entries if not e.key.startswith(OBS_KEY_PREFIX)
            ):
                h.update(d.encode())
                h.update(b"\n")
            self._digest = h.hexdigest()[:DIGEST_HEX_LEN]
        return self._digest

    # -- dunder ------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    def __iter__(self) -> Iterator[ContextEntry]:
        return iter(sorted(self._entries, key=lambda e: (e.lamport, e.key, e.origin)))

    def __contains__(self, key: str) -> bool:
        return any(e.key == key for e in self._entries)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Context) and self._entries == other._entries

    def __hash__(self) -> int:
        return hash(self._entries)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Context({len(self._entries)} facts, digest={self.digest()})"

    # -- serialization (for the journal / cross-host transfer) -------------
    def to_wire(self) -> list:
        return [[e.key, e.origin, e.lamport, e.value_json.decode()] for e in self]

    @staticmethod
    def from_wire(wire: Iterable) -> "Context":
        return Context(
            ContextEntry(key=k, origin=o, lamport=int(l), value_json=v.encode())
            for k, o, l, v in wire
        )


EMPTY_CONTEXT = Context()
