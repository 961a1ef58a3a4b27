"""Tagged-frame compression with graceful zstd fallback: a copy of ``repro.wire.compress``.

The same tags and the same frames, so either package reads the other's
journals and checkpoints. Every compressed frame is prefixed with a one-byte
tag so the decompressor is self-describing:

    0x00  raw (no compression)
    0x01  zlib (stdlib — always available)
    0x02  zstd (when the optional ``zstandard`` package is installed)

``compress`` picks the best available scheme (zstd > zlib); ``decompress``
dispatches on the tag, so a journal written on a zstd host replays on a
zlib-only host as long as the frames it contains are zlib/raw — and a frame
that *requires* zstd fails with an actionable error instead of a crash.
Legacy untagged zstd frames from seed journals (magic ``0x28 B5 2F FD``) are
detected and decompressed when zstd is available.
"""

from __future__ import annotations

import zlib

__all__ = ["compress", "decompress", "zstd_available", "TAG_RAW", "TAG_ZLIB", "TAG_ZSTD"]

TAG_RAW = 0x00
TAG_ZLIB = 0x01
TAG_ZSTD = 0x02

_ZSTD_MAGIC_BYTE = 0x28  # first byte of the zstd frame magic 0x28B52FFD

try:
    import zstandard as _zstd
except ImportError:  # optional: repro[compression]
    _zstd = None


def zstd_available() -> bool:
    """True iff the optional ``zstandard`` package is importable."""
    return _zstd is not None


def compress(data: bytes, level: int = 3) -> bytes:
    """Compress with the best available scheme, prefixed with its tag byte."""
    if _zstd is not None:
        return bytes([TAG_ZSTD]) + _zstd.ZstdCompressor(level=level).compress(data)
    return bytes([TAG_ZLIB]) + zlib.compress(data, min(level * 2, 9))


def decompress(frame: bytes) -> bytes:
    """Decompress a tagged frame, dispatching on its self-describing tag byte."""
    if not frame:
        raise ValueError("empty compression frame")
    tag = frame[0]
    body = frame[1:]
    if tag == TAG_RAW:
        return body
    if tag == TAG_ZLIB:
        return zlib.decompress(body)
    if tag == TAG_ZSTD:
        if _zstd is None:
            raise ImportError(
                "frame is zstd-compressed but 'zstandard' is not installed; "
                "pip install zstandard (the repro[compression] extra)"
            )
        return _zstd.ZstdDecompressor().decompress(body)
    if tag == _ZSTD_MAGIC_BYTE:  # legacy seed-era frame: untagged raw zstd
        if _zstd is None:
            raise ImportError(
                "frame looks like a legacy untagged zstd frame but "
                "'zstandard' is not installed; pip install zstandard "
                "(the repro[compression] extra) to read it"
            )
        return _zstd.ZstdDecompressor().decompress(frame)
    raise ValueError(f"unknown compression tag 0x{tag:02x}")
