"""Canonical form and digests: a copy of ``repro.wire.base`` and its stdlib JSON codec.

The canonical form is the hashing form of a value: UTF-8 JSON of the
normalized value tree, sorted keys, compact separators, written by the
stdlib encoder. The reference writes it with the stdlib encoder under every
one of its codecs (``repro.wire.base.Codec.canonical_bytes``), so the port's
``canonical_digest`` is the reference's for the same value, whatever codec
the reference's host selected.

Normalization rules (applied before canonical encoding):
  - mappings     → dict, keys sorted lexicographically (non-``str`` keys are
    a ``TypeError`` — coercion would collide distinct values on one digest)
  - list / tuple → list
  - set / frozenset → sorted list
  - bytes / bytearray → lowercase hex string
  - objects with ``__array__`` (numpy arrays and scalars, CPU tensors) →
    nested lists of native scalars via ``np.asarray(x).tolist()``; a tensor
    on a device raises (``host_array``); bfloat16 (a ``BFloat16Array`` or a
    CPU tensor) → its values as Python floats, which is what the reference's
    ``tolist()`` of an ``ml_dtypes.bfloat16`` array gives
  - NaN / ±Inf floats → ``None``
  - str / int / float / bool / None pass through
Anything else raises ``TypeError``.
"""

from __future__ import annotations

import hashlib
import json
import math
from typing import Any, Mapping

import numpy as np

from .bfloat16 import BFloat16Array

__all__ = [
    "DIGEST_HEX_LEN",
    "JsonCodec",
    "canonical_bytes",
    "canonical_digest",
    "from_canonical",
    "host_array",
    "normalize",
    "stdlib_canonical",
]

DIGEST_HEX_LEN = 16  # sha256 truncated to 64 bits of hex — the journal id width


def host_array(value: Any) -> np.ndarray:
    """``np.asarray(value)``, refusing a tensor that numpy cannot read where it is.

    A tensor on a device would fail deep inside numpy with a ``TypeError`` that
    names neither the value nor the way out; this names both. bfloat16, which
    numpy has no dtype for, comes back as a :class:`BFloat16Array` of its bits:
    one given (as it is) or a CPU tensor's.
    """
    if isinstance(value, BFloat16Array):
        return value
    device = getattr(value, "device", None)
    if getattr(device, "type", "cpu") != "cpu":
        raise TypeError(
            f"a tensor on {device} cannot be digested or encoded; bring the tree to the host "
            "first with repro_torch.train.host.to_host"
        )
    if str(getattr(value, "dtype", "")) == "torch.bfloat16":
        import torch  # the value is a tensor: torch is loaded

        return BFloat16Array(value.detach().view(torch.int16).numpy())
    return np.asarray(value)


def normalize(value: Any) -> Any:
    """Reduce ``value`` to a JSON-native tree with deterministic ordering."""
    if value is None or isinstance(value, (str, bool, int)):
        return value
    if isinstance(value, float):
        return value if math.isfinite(value) else None
    if isinstance(value, Mapping):
        for k in value:
            if not isinstance(k, str):
                # coercing with str(k) would let {1: 'a'} and {'1': 'a'}
                # collide on one digest — reject, as the reference does
                raise TypeError(
                    f"mapping keys must be str for canonical encoding, got {type(k).__name__!r}"
                )
        return {k: normalize(value[k]) for k in sorted(value)}
    if isinstance(value, (list, tuple)):
        return [normalize(v) for v in value]
    if isinstance(value, (set, frozenset)):
        return [normalize(v) for v in sorted(value)]
    if isinstance(value, (bytes, bytearray)):
        return bytes(value).hex()
    if hasattr(value, "__array__"):
        arr = host_array(value)
        if isinstance(arr, BFloat16Array):
            arr = arr.float32()  # exact: the floats the reference's tolist() gives
        return normalize(arr.tolist())
    raise TypeError(f"wire value of type {type(value)!r} is not serializable")


def stdlib_canonical(tree: Any) -> bytes:
    """Canonical JSON bytes of an already-normalized tree (stdlib encoder)."""
    return json.dumps(tree, ensure_ascii=False, allow_nan=False, separators=(",", ":")).encode(
        "utf-8"
    )


def canonical_bytes(value: Any) -> bytes:
    """Backend-stable hashing bytes of ``value``: canonical JSON of the normalized tree."""
    return stdlib_canonical(normalize(value))


def canonical_digest(value: Any) -> str:
    """Truncated sha256 of :func:`canonical_bytes` — the journal id form."""
    return hashlib.sha256(canonical_bytes(value)).hexdigest()[:DIGEST_HEX_LEN]


def from_canonical(data: bytes) -> Any:
    """Parse canonical bytes (always JSON)."""
    return json.loads(data)


class JsonCodec:
    """Stdlib JSON: transport bytes ARE the canonical bytes; ``pretty=True``
    indents, for on-disk manifests."""

    def encode(self, obj: Any, pretty: bool = False) -> bytes:
        tree = normalize(obj)
        if pretty:
            return json.dumps(tree, ensure_ascii=False, allow_nan=False, indent=1).encode("utf-8")
        return stdlib_canonical(tree)

    def decode(self, data: bytes) -> Any:
        return json.loads(data)
