"""Cached-decode attention: the hand-written Hopper kernel and its wrapper.

The reference computes this step in plain jnp (the cached-decode branch of
``repro.models.attention.gqa_attention``); there is no TPU kernel. The port
has one because a slot's result must be the same bits whatever batch it is
decoded in, and only a kernel owns its reduction order: ``csrc/decode_attention.cu``
(CUDA C++ for ``sm_90a``, built by :mod:`._build`) splits the cache into blocks
of :data:`SPLIT_KEYS` slots, so the split count is a function of Sc alone, and
merges the splits in a fixed order, with no atomics. Its source note says what
bounds it.

On a CUDA tensor the wrapper launches the kernel or raises. On a CPU tensor it
runs the plain version, :func:`repro_torch.kernels.ref.decode_attention_ref`,
and only because the tensor lies on the CPU. The same checks apply on both
devices, so the CPU tests see what the kernel would refuse.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import ref as _ref
from ._build import count_launch

__all__ = ["decode_attention", "split_plan", "MAX_SPLITS", "MAX_GROUP", "MAX_HEAD_DIM", "MAX_CACHE"]

#: splits of a cache, at most: the blocks of one portable thread-block cluster
MAX_SPLITS = 8
_GROUP = 8  # cache slots a warp takes at a time (``GROUP`` in the source)
_MIN_SPLIT_KEYS = 64
#: query heads a KV head, at most: the 16 rows of an ``mma.sync``
MAX_GROUP = 16
MAX_HEAD_DIM = 256
#: cache slots, at most: a block then walks at most 32,768 of them
MAX_CACHE = 262144
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_YZ = 65535


def _check(q, k_cache, v_cache, pos, window) -> None:
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"decode_attention: q {tuple(q.shape)} must be (B, H, D) and the caches "
            f"k {tuple(k_cache.shape)}, v {tuple(v_cache.shape)} both (B, Sc, KV, D)"
        )
    b, h, d = q.shape
    _, sc, kv, dk = k_cache.shape
    if k_cache.shape[0] != b or dk != d:
        raise ValueError(
            f"decode_attention: q {tuple(q.shape)} does not fit the cache {tuple(k_cache.shape)}"
        )
    if b < 1 or sc < 1 or kv < 1:
        raise ValueError(f"decode_attention: an empty axis in the cache {tuple(k_cache.shape)}")
    if sc > MAX_CACHE:
        raise ValueError(f"decode_attention: Sc={sc}; the kernel takes at most {MAX_CACHE} slots")
    if h % kv != 0 or h // kv > MAX_GROUP:
        raise ValueError(
            f"decode_attention: H={h}, KV={kv}; H must be a multiple of KV with at most "
            f"{MAX_GROUP} query heads a KV head"
        )
    if d % 8 != 0 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: D={d}; the kernel takes multiples of 8 up to 256")
    if q.dtype not in _DTYPES:
        raise TypeError(f"decode_attention: q is {q.dtype}; it must be float32 or bfloat16")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(
            f"decode_attention: q, k, v are {q.dtype}, {k_cache.dtype}, {v_cache.dtype}; "
            "they must agree"
        )
    if pos.shape != (b,) or pos.dtype != torch.int32:
        raise TypeError(
            f"decode_attention: pos {tuple(pos.shape)} {pos.dtype}, expected ({b},) int32"
        )
    if window is not None and window < 1:
        raise ValueError(f"decode_attention: window={window}; it must be None or >= 1")
    tensors = (q, k_cache, v_cache, pos)
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("decode_attention: q, the caches and pos must be contiguous")
    if any(x.device != q.device for x in tensors):
        raise ValueError("decode_attention: q, the caches and pos on different devices")
    if b > _MAX_GRID_YZ or kv > _MAX_GRID_YZ:
        raise ValueError(f"decode_attention: B={b} or KV={kv} exceeds the grid limit")


def split_plan(sc: int) -> Tuple[int, int]:
    """(cache slots a split, splits) for a cache of ``sc`` slots: a function of Sc alone.

    ceil(Sc / MAX_SPLITS) rounded up to whole groups of 8 slots, at least 64; the
    source's ``split_keys`` and ``n_splits`` compute the same, and the kernel refuses
    a split count that differs.
    """
    keys = max(_MIN_SPLIT_KEYS, -(-(-(-sc // MAX_SPLITS)) // _GROUP) * _GROUP)
    return keys, -(-sc // keys)


def _lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.load("decode_attention")
    fn = lib.repro_decode_attention
    if fn.argtypes is None:  # first use: declare the C signature
        # argtypes last: it is the flag another thread tests above
        fn.restype = ctypes.c_int
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        fn.argtypes = [ptr] * 5 + [i32] * 7 + [ctypes.c_float, i32, ptr]
    return lib


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos: torch.Tensor,
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """q (B,H,D), k_cache and v_cache (B,Sc,KV,D) in q's dtype (float32|bfloat16), pos (B,)
    int32 -> (B,H,D) in q's dtype. A cache of ``window`` slots is a ring.

    ``decode_attention.launches`` counts kernel launches (never the CPU path).
    """
    _check(q, k_cache, v_cache, pos, window)
    if q.device.type == "cpu":
        return _ref.decode_attention_ref(q, k_cache, v_cache, pos, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    b, h, d = q.shape
    sc, kv = k_cache.shape[1], k_cache.shape[2]
    ring = window if window is not None and sc == window else 0
    n_split = split_plan(sc)[1]
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_decode_attention(
            q.data_ptr(),
            k_cache.data_ptr(),
            v_cache.data_ptr(),
            pos.data_ptr(),
            out.data_ptr(),
            b,
            h,
            kv,
            sc,
            d,
            ring,
            n_split,
            d**-0.5,
            int(q.dtype == torch.bfloat16),
            stream,
        )
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"decode_attention: launch failed: CUDA error {err} ({msg})")
    count_launch(decode_attention)
    return out


decode_attention.launches = 0
