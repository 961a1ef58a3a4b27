"""Payload codec: a copy of ``repro.wire.payload``'s ``encode_payload``,
``decode_payload`` and ``payload_digest``.

The journal/RPC *body* format: msgpack with ExtType array frames (the port's
own encoder, :mod:`repro_torch.wire.packer`, byte for byte the reference's),
wrapped in a tagged compression frame (:mod:`repro_torch.wire.compress`).
Either package decodes the other's frames.

``payload_digest`` is the deterministic identity of a payload pytree — it
feeds sha256 directly from array buffers (no serialization round-trip), so
it is compression- and codec-independent by construction. A tensor on a
device raises: digest the host copy (``repro_torch.train.host.to_host``).

The reference's ``Digested`` wrapper and stream frames are not copied:
nothing in the port uses them.
"""

from __future__ import annotations

import hashlib
from typing import Any, Mapping

import numpy as np

from .base import DIGEST_HEX_LEN, host_array
from .compress import compress, decompress
from .packer import packb, unpackb

__all__ = ["PayloadDecodeError", "encode_payload", "decode_payload", "payload_digest"]


class PayloadDecodeError(ValueError):
    """A payload frame that cannot be decoded (corrupt or incompatible bytes)."""


def encode_payload(obj: Any, level: int = 3) -> bytes:
    """Encode a pytree as a tagged-compressed msgpack frame (journal body)."""
    return compress(packb(obj), level=level)


def decode_payload(buf: bytes) -> Any:
    """Inverse of :func:`encode_payload`; malformed bytes raise PayloadDecodeError."""
    try:
        return unpackb(decompress(buf))
    except ImportError:
        raise  # actionable "install zstandard" from repro_torch.wire.compress
    except Exception as exc:
        raise PayloadDecodeError(f"undecodable payload frame: {exc}") from exc


def payload_digest(obj: Any) -> str:
    """Digest of a payload pytree — used as the deterministic input/output id."""
    h = hashlib.sha256()

    def _feed(x: Any) -> None:
        if isinstance(x, Mapping):
            for k in sorted(x, key=str):
                h.update(str(k).encode())
                _feed(x[k])
        elif isinstance(x, (list, tuple)):
            h.update(b"[")
            for v in x:
                _feed(v)
            h.update(b"]")
        elif hasattr(x, "__array__"):
            arr = host_array(x)
            h.update(arr.dtype.str.encode())
            h.update(str(arr.shape).encode())
            h.update(np.ascontiguousarray(arr).tobytes())
        else:
            h.update(repr(x).encode())

    _feed(obj)
    return h.hexdigest()[:DIGEST_HEX_LEN]
