"""Payload digests: a copy of ``repro.wire.payload.payload_digest``.

The port imports nothing of ``repro``; it keeps this one function so that
``serve.Request.digest()`` is the same id the JAX package computes for the
same request (``tests/test_torch_batcher.py`` holds them equal). The
``Digested`` passthrough and the codecs are not copied: nothing here uses
them.
"""

from __future__ import annotations

import hashlib
from collections.abc import Mapping
from typing import Any

import numpy as np

__all__ = ["DIGEST_HEX_LEN", "payload_digest"]

DIGEST_HEX_LEN = 16  # sha256 truncated to 64 bits of hex: the journal id width


def payload_digest(obj: Any) -> str:
    """Digest of a payload pytree, used as the deterministic input/output id."""
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
            arr = np.asarray(x)
            h.update(arr.dtype.str.encode())
            h.update(str(arr.shape).encode())
            h.update(np.ascontiguousarray(arr).tobytes())
        else:
            h.update(repr(x).encode())

    _feed(obj)
    return h.hexdigest()[:DIGEST_HEX_LEN]
