"""A small msgpack encoder and decoder, so that the port needs no ``msgpack`` package.

The journal bodies and payloads of the reference are msgpack
(``repro.wire.payload.encode_payload``:
``msgpack.packb(obj, default=pack_default, use_bin_type=True)``), and the
card's machine has no msgpack. :func:`packb` gives, byte for byte, what that
call gives for the values journal records and payloads hold:

  - None, bool, int (−2**63 .. 2**64 − 1, each in its smallest form),
    float (always float64), str (str8/16/32), bytes / bytearray /
    memoryview (bin8/16/32), list and tuple (arrays), dict (maps, in the
    dict's order);
  - through the reference's ``pack_default`` hook: objects with
    ``__array__`` as ext type 1 holding ``(dtype.str, shape, raw bytes)``,
    complex as ext type 2, set / frozenset as a sorted array. A bfloat16
    leaf (:class:`~repro_torch.wire.bfloat16.BFloat16Array`, or a CPU
    tensor) holds ``("<V2", shape, bits)``, as the reference packs an
    ``ml_dtypes.bfloat16`` array.

:func:`unpackb` reads what ``msgpack.unpackb(raw=False, strict_map_key=False,
ext_hook=unpack_ext)`` reads: str as str, bin as bytes, arrays as lists,
ext type 1 as a read-only ndarray, ext type 2 as complex; other ext types
come back as :class:`ExtType`. An array of ``"<V2"`` comes back as a
``BFloat16Array``: the port has no other 2-byte void. The reference's
``unpack_ext`` reads the same frame as a plain ``|V2`` array of the bits
(``np.dtype("<V2")`` is a void), not as bfloat16.
"""

from __future__ import annotations

import struct
from typing import Any, NamedTuple, Tuple

import numpy as np

from .base import host_array
from .bfloat16 import WIRE_DTYPE, BFloat16Array, wire_dtype

__all__ = ["EXT_NDARRAY", "EXT_COMPLEX", "ExtType", "packb", "unpackb"]

EXT_NDARRAY = 1
EXT_COMPLEX = 2


class ExtType(NamedTuple):
    """An ext frame: its type code and its bytes."""

    code: int
    data: bytes


def _pack_default(obj: Any) -> Any:
    """The reference's ``pack_default`` hook: arrays/complex/sets → ExtType or a list."""
    if hasattr(obj, "__array__"):  # numpy arrays and scalars, CPU tensors
        arr = host_array(obj)
        return ExtType(EXT_NDARRAY, packb((wire_dtype(arr), arr.shape, arr.tobytes())))
    if isinstance(obj, complex):
        return ExtType(EXT_COMPLEX, packb((obj.real, obj.imag)))
    if isinstance(obj, (set, frozenset)):
        return sorted(obj)
    raise TypeError(f"unpackable type {type(obj)!r}")


def _pack_int(n: int, out: bytearray) -> bool:
    """Append ``n`` in msgpack's smallest form; False if it needs more than 64 bits."""
    if n > 0:
        if n < 1 << 7:
            out.append(n)
        elif n < 1 << 8:
            out += b"\xcc" + struct.pack(">B", n)
        elif n < 1 << 16:
            out += b"\xcd" + struct.pack(">H", n)
        elif n < 1 << 32:
            out += b"\xce" + struct.pack(">I", n)
        elif n < 1 << 64:
            out += b"\xcf" + struct.pack(">Q", n)
        else:
            return False
    elif n >= -(1 << 5):
        out += struct.pack(">b", n)  # 0 and negative fixint
    elif n >= -(1 << 7):
        out += b"\xd0" + struct.pack(">b", n)
    elif n >= -(1 << 15):
        out += b"\xd1" + struct.pack(">h", n)
    elif n >= -(1 << 31):
        out += b"\xd2" + struct.pack(">i", n)
    elif n >= -(1 << 63):
        out += b"\xd3" + struct.pack(">q", n)
    else:
        return False
    return True


def _pack_len(n: int, out: bytearray, fix: int, fix_max: int, wide: Tuple[bytes, ...]) -> None:
    """A header of a container or string: fix form below ``fix_max`` (if any), then 8-,
    16- and 32-bit lengths as ``wide`` lists them (``wide`` has 3 codes, or 2 with no
    8-bit form)."""
    if n < fix_max:
        out.append(fix | n)
        return
    forms = (("B", 1 << 8), ("H", 1 << 16), ("I", 1 << 32))[3 - len(wide) :]
    for code, (fmt, limit) in zip(wide, forms, strict=True):
        if n < limit:
            out += code + struct.pack(">" + fmt, n)
            return
    raise ValueError(f"msgpack: length {n} is too large")


def _pack(obj: Any, out: bytearray, default_used: bool = False) -> None:
    while True:
        if obj is None:
            out.append(0xC0)
        elif obj is True:
            out.append(0xC3)
        elif obj is False:
            out.append(0xC2)
        elif isinstance(obj, int):
            if not _pack_int(obj, out):
                if default_used:
                    raise OverflowError("Integer value out of range")
                obj, default_used = _pack_default(obj), True
                continue
        elif isinstance(obj, float):
            out += b"\xcb" + struct.pack(">d", obj)
        elif isinstance(obj, (bytes, bytearray)):
            _pack_len(len(obj), out, 0, 0, (b"\xc4", b"\xc5", b"\xc6"))
            out += obj
        elif isinstance(obj, str):
            raw = obj.encode("utf-8")
            _pack_len(len(raw), out, 0xA0, 32, (b"\xd9", b"\xda", b"\xdb"))
            out += raw
        elif isinstance(obj, dict):
            _pack_len(len(obj), out, 0x80, 16, (b"\xde", b"\xdf"))
            for k, v in obj.items():
                _pack(k, out)
                _pack(v, out)
        elif isinstance(obj, ExtType):
            n = len(obj.data)
            fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
            if n in fixext:
                out.append(fixext[n])
            else:
                _pack_len(n, out, 0, 0, (b"\xc7", b"\xc8", b"\xc9"))
            out += struct.pack(">b", obj.code) + obj.data
        elif isinstance(obj, (list, tuple)):
            _pack_len(len(obj), out, 0x90, 16, (b"\xdc", b"\xdd"))
            for v in obj:
                _pack(v, out)
        elif isinstance(obj, memoryview):
            _pack_len(obj.nbytes, out, 0, 0, (b"\xc4", b"\xc5", b"\xc6"))
            out += obj.tobytes()
        elif not default_used:
            obj, default_used = _pack_default(obj), True
            continue
        else:
            raise TypeError(f"can not serialize {type(obj).__name__!r} object")
        return


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, default=pack_default, use_bin_type=True)``, byte for byte."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# -- decoding -----------------------------------------------------------------

_FIXED = {  # code: (struct format, size) of the scalar forms
    0xCA: (">f", 4),
    0xCB: (">d", 8),
    0xCC: (">B", 1),
    0xCD: (">H", 2),
    0xCE: (">I", 4),
    0xCF: (">Q", 8),
    0xD0: (">b", 1),
    0xD1: (">h", 2),
    0xD2: (">i", 4),
    0xD3: (">q", 8),
}
_LENGTHS = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("msgpack: truncated data")
        out = self.buf[self.pos : end].tobytes()
        self.pos = end
        return out

    def number(self, fmt: str, size: int) -> Any:
        return struct.unpack(fmt, self.take(size))[0]

    def length(self, size: int) -> int:
        return self.number(_LENGTHS[size], size)

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _FIXED:
            return self.number(*_FIXED[b])
        if b in (0xC4, 0xC5, 0xC6):
            return self.take(self.length(1 << (b - 0xC4)))
        if b in (0xD9, 0xDA, 0xDB):
            return self.take(self.length(1 << (b - 0xD9))).decode("utf-8")
        if b in (0xDC, 0xDD):
            return [self.value() for _ in range(self.length(2 << (b - 0xDC)))]
        if b in (0xDE, 0xDF):
            return self.map(self.length(2 << (b - 0xDE)))
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.length(1 << (b - 0xC7)))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int) -> Any:
        code = struct.unpack(">b", self.take(1))[0]
        data = self.take(n)
        if code == EXT_NDARRAY:
            dtype, shape, raw = unpackb(data)
            arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
            return BFloat16Array(arr) if dtype == WIRE_DTYPE else arr
        if code == EXT_COMPLEX:
            re_, im = unpackb(data)
            return complex(re_, im)
        return ExtType(code, data)


def unpackb(data: bytes) -> Any:
    """The one value ``data`` holds; trailing bytes or a short frame raise ``ValueError``."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError("msgpack: extra data after the value")
    return out
