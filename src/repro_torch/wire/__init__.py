"""Canonical serialization, digests and the payload codec: the port's copy of ``repro.wire``.

  - ``canonical_bytes`` / ``canonical_digest`` / ``from_canonical``: the
    hashing form, stdlib JSON, the same bytes the reference hashes under any
    of its codecs (``base``);
  - ``encode_payload`` / ``decode_payload`` / ``payload_digest``: the
    compressed msgpack pytree codec of the journal and the worker RPC
    (``payload``), msgpack by the port's own encoder (``packer``);
    ``Digested`` / ``unwrap_digested``, the precomputed-digest hint;
    ``encode_frame`` / ``read_frames``, the crc-checked frames of a stream;
  - ``compress`` / ``decompress``: tagged-frame compression, zstd when the
    optional ``zstandard`` is installed, else zlib (``compress``).

The port never imports ``msgpack`` or ``orjson``, and ``zstandard`` only
optionally: the card's machine has none of them. The reference's codec
registry (``REPRO_WIRE_CODEC``) is not copied: the port's transport is
msgpack and its canonical form JSON, which is what every codec of the
reference hashes.
"""

from .base import (
    DIGEST_HEX_LEN,
    JsonCodec,
    canonical_bytes,
    canonical_digest,
    from_canonical,
    host_array,
    normalize,
    stdlib_canonical,
)
from .compress import compress, decompress, zstd_available
from .payload import (
    FRAME_HEADER,
    Digested,
    PayloadDecodeError,
    decode_payload,
    encode_frame,
    encode_payload,
    payload_digest,
    read_frames,
    unwrap_digested,
)

__all__ = [
    "DIGEST_HEX_LEN",
    "Digested",
    "FRAME_HEADER",
    "JsonCodec",
    "PayloadDecodeError",
    "canonical_bytes",
    "canonical_digest",
    "compress",
    "decode_payload",
    "decompress",
    "encode_frame",
    "encode_payload",
    "from_canonical",
    "host_array",
    "normalize",
    "payload_digest",
    "read_frames",
    "stdlib_canonical",
    "unwrap_digested",
    "zstd_available",
]
