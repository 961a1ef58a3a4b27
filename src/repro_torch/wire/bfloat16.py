"""bfloat16 on the host, without ``ml_dtypes``.

Numpy has no bfloat16, and the card's machine has no ``ml_dtypes`` (the package that
gives numpy one, which the reference's arrays carry). So the port holds a bfloat16 value
on the host as its raw 16-bit patterns, in a :class:`BFloat16Array`: an array of 2-byte
voids (``|V2``, the dtype ``np.load`` gives a bfloat16 member of an npz) that says it is
bfloat16 and refuses arithmetic. A bare ``uint16`` array would not refuse it:
``np.asarray(bits, dtype=np.float32)`` averages integers without a word.

Every durable surface treats a :class:`BFloat16Array` as the reference treats an
``ml_dtypes.bfloat16`` array with the same bits:

  - the checkpoint digest and manifest: ``str(dtype)``, ``"bfloat16"`` (:func:`dtype_name`);
  - ``payload_digest`` and the msgpack ext frame: ``dtype.str``, ``"<V2"`` (:func:`wire_dtype`);
  - the canonical form: the values as Python floats (:meth:`BFloat16Array.float32`, exact).
"""

from __future__ import annotations

from typing import Any

import numpy as np

__all__ = [
    "BFLOAT16",
    "BITS",
    "WIRE_DTYPE",
    "BFloat16Array",
    "dtype_name",
    "from_float32",
    "wire_dtype",
]

BFLOAT16 = "bfloat16"  # str(dtype) of the reference's arrays: its checkpoint digests and manifests
BITS = np.dtype("V2")  # the host form's dtype, as np.load reads a bfloat16 npz member
WIRE_DTYPE = "<V2"  # dtype.str of the reference's arrays: its payload digests and ext frames


class BFloat16Array(np.ndarray):
    """bfloat16 values on the host as their bits, in an ``|V2`` array of its own.

    ``BFloat16Array(bits)`` takes any array of 2-byte items (``uint16``, ``int16`` or
    ``|V2``) and copies it only if it is not C-contiguous. Slicing keeps the type; every
    ufunc raises ``TypeError``, and numpy refuses a cast to a number type by itself.
    """

    def __new__(cls, bits: Any) -> "BFloat16Array":
        arr = np.asarray(bits)
        if arr.dtype.itemsize != 2 or arr.dtype.kind not in "uiV":
            raise TypeError(f"BFloat16Array holds 2-byte bit patterns, got {arr.dtype}")
        if not arr.flags.c_contiguous:
            arr = arr.copy(order="C")
        return arr.view(BITS).view(cls)

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        raise TypeError(
            f"{ufunc.__name__}: a BFloat16Array holds bfloat16 bit patterns and does no "
            "arithmetic; take .float32() for the values"
        )

    def bits(self) -> np.ndarray:
        """The bit patterns as a plain ``uint16`` array (a view)."""
        return np.asarray(self).view(np.uint16)

    def float32(self) -> np.ndarray:
        """The values as float32 (exact: a bfloat16 is a float32 with 16 low zero bits)."""
        wide = self.bits().astype(np.uint32)
        wide <<= 16  # in place: a 0-d array stays an array
        return wide.view(np.float32)


def from_float32(values: Any) -> BFloat16Array:
    """float32 values rounded once to the nearest bfloat16, ties to even, as
    ``ml_dtypes``' cast rounds them: subnormals kept, ±inf kept, past the largest finite
    value to ±inf, and a NaN the quiet NaN of its sign."""
    x = np.asarray(values, dtype=np.float32, order="C")
    bits = x.view(np.uint32)
    rounded = (bits + (np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1)))) >> 16
    quiet = ((bits >> 16) & np.uint32(0x8000)) | np.uint32(0x7FC0)
    return BFloat16Array(np.where(np.isnan(x), quiet, rounded).astype(np.uint16))


def dtype_name(arr: np.ndarray) -> str:
    """``str(arr.dtype)``, and ``"bfloat16"`` for a :class:`BFloat16Array`."""
    return BFLOAT16 if isinstance(arr, BFloat16Array) else str(arr.dtype)


def wire_dtype(arr: np.ndarray) -> str:
    """``arr.dtype.str``, and ``"<V2"`` (``ml_dtypes.bfloat16``'s) for a :class:`BFloat16Array`."""
    return WIRE_DTYPE if isinstance(arr, BFloat16Array) else arr.dtype.str
