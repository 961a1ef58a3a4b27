"""Payload codec and stream frames: a copy of ``repro.wire.payload``.

The journal/RPC *body* format: msgpack with ExtType array frames (the port's
own encoder, :mod:`repro_torch.wire.packer`, byte for byte the reference's),
wrapped in a tagged compression frame (:mod:`repro_torch.wire.compress`).
Either package decodes the other's frames.

``payload_digest`` is the deterministic identity of a payload pytree — it
feeds sha256 directly from array buffers (no serialization round-trip), so
it is compression- and codec-independent by construction. A tensor on a
device raises: digest the host copy (``repro_torch.train.host.to_host``).
A bfloat16 leaf hashes as the reference's ``ml_dtypes`` array with the same
bits: ``"<V2"``, the shape, the bits (:mod:`repro_torch.wire.bfloat16`).
"""

from __future__ import annotations

import binascii
import hashlib
import struct
from typing import Any, BinaryIO, Iterator, Mapping

import numpy as np

from .base import DIGEST_HEX_LEN, host_array
from .bfloat16 import wire_dtype
from .compress import compress, decompress
from .packer import packb, unpackb

__all__ = [
    "PayloadDecodeError",
    "Digested",
    "unwrap_digested",
    "encode_payload",
    "decode_payload",
    "payload_digest",
    "encode_frame",
    "read_frames",
    "FRAME_HEADER",
]


class Digested:
    """A payload value carrying its precomputed :func:`payload_digest`.

    ``Digested.wrap(tree)`` hashes a large tree once; every later
    :func:`payload_digest` over it folds in the fixed-size token instead of
    re-feeding the buffers. A *scheduling-layer* hint, never a wire type: the
    gateway and workers unwrap it (:func:`unwrap_digested`) before a task
    function or transport sees the value, and :func:`encode_payload` strips
    any wrapper left in an encoded tree, so a digest or a frame is the same
    whether the value was wrapped or not. The wrapper's owner answers for the
    digest matching the value.
    """

    __slots__ = ("value", "digest")

    def __init__(self, value: Any, digest: str):
        self.value = value
        self.digest = digest

    @staticmethod
    def wrap(value: Any) -> "Digested":
        """Wrap ``value`` with its freshly computed payload digest."""
        return Digested(value, payload_digest(value))

    def __repr__(self) -> str:  # keep tensor pytrees out of logs/errors
        return f"Digested({self.digest})"


def unwrap_digested(obj: Any) -> Any:
    """Strip :class:`Digested` wrappers from a payload pytree.

    Copy-on-write: containers are rebuilt only along paths that hold a
    wrapper, so a wrapper-free tree comes back as the same object.
    """
    if isinstance(obj, Digested):
        return unwrap_digested(obj.value)
    if isinstance(obj, dict):
        out = {k: unwrap_digested(v) for k, v in obj.items()}
        return obj if all(out[k] is obj[k] for k in out) else out
    if isinstance(obj, (list, tuple)):
        vals = [unwrap_digested(v) for v in obj]
        if all(a is b for a, b in zip(vals, obj, strict=True)):
            return obj
        if isinstance(obj, tuple) and hasattr(obj, "_fields"):
            return type(obj)(*vals)  # NamedTuple: positional reconstruction
        return type(obj)(vals)
    return obj


class PayloadDecodeError(ValueError):
    """A payload frame that cannot be decoded (corrupt or incompatible bytes)."""


def encode_payload(obj: Any, level: int = 3) -> bytes:
    """Encode a pytree as a tagged-compressed msgpack frame (journal body).

    :class:`Digested` wrappers are stripped first: the digest hint is
    process-local scheduling state, never part of the wire format.
    """
    return compress(packb(unwrap_digested(obj)), level=level)


def decode_payload(buf: bytes) -> Any:
    """Inverse of :func:`encode_payload`; malformed bytes raise PayloadDecodeError."""
    try:
        return unpackb(decompress(buf))
    except ImportError:
        raise  # actionable "install zstandard" from repro_torch.wire.compress
    except Exception as exc:
        raise PayloadDecodeError(f"undecodable payload frame: {exc}") from exc


# -- chunk framing (streaming transport) ------------------------------------
#
# A *frame* is one length-prefixed, checksummed payload on a byte stream: the
# journal's ``(length: u32, crc32: u32, body)`` layout, so a stream of frames
# is torn-tail-safe at frame granularity. Frames carry the stream protocol's
# chunk / EOS / error maps; the framing itself is payload-agnostic.

FRAME_HEADER = struct.Struct("<II")  # (length, crc32): the journal's


def encode_frame(obj: Any) -> bytes:
    """One self-delimiting frame: header + tagged-compressed payload body."""
    body = encode_payload(obj)
    return FRAME_HEADER.pack(len(body), binascii.crc32(body)) + body


def read_frames(fp: BinaryIO) -> Iterator[Any]:
    """Decode frames off a blocking byte stream until EOF.

    A short read mid-frame (the producer died between frames) or a crc
    mismatch raises :class:`PayloadDecodeError`: a torn stream is detected,
    never silently truncated, because the consumer must tell EOS from a lost
    producer.
    """
    while True:
        header = fp.read(FRAME_HEADER.size)
        if not header:
            return
        if len(header) < FRAME_HEADER.size:
            raise PayloadDecodeError("torn stream: partial frame header")
        length, crc = FRAME_HEADER.unpack(header)
        body = b""
        while len(body) < length:
            piece = fp.read(length - len(body))
            if not piece:
                raise PayloadDecodeError("torn stream: partial frame body")
            body += piece
        if binascii.crc32(body) != crc:
            raise PayloadDecodeError("corrupt stream frame (crc mismatch)")
        yield decode_payload(body)


def payload_digest(obj: Any) -> str:
    """Digest of a payload pytree — used as the deterministic input/output id."""
    h = hashlib.sha256()

    def _feed(x: Any) -> None:
        if isinstance(x, Digested):  # precomputed: fold the token, not the value
            h.update(b"digested:")
            h.update(x.digest.encode())
        elif isinstance(x, Mapping):
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
            h.update(wire_dtype(arr).encode())  # bfloat16: "<V2", the reference's dtype.str
            h.update(str(arr.shape).encode())
            h.update(np.ascontiguousarray(arr).tobytes())
        else:
            h.update(repr(x).encode())

    _feed(obj)
    return h.hexdigest()[:DIGEST_HEX_LEN]
