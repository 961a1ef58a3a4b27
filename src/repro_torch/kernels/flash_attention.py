"""Flash-attention forward: the hand-written Hopper kernels and their wrapper.

Counterpart of ``repro.kernels.flash_attention.flash_attention_pallas``.
The kernels are in ``csrc/flash_attention_fwd.cu`` (CUDA C++ for
``sm_90a``, built by :mod:`._build`); its source note says what they
replace and what bounds them. Both dtypes run on the tensor cores, one
kernel a dtype with no fallback between them: bfloat16 through ``wgmma``
fed by TMA, float32 through ``mma.sync`` in 3xTF32 (each operand split
into TF32 hi and lo halves, three products a step: float32 accuracy). The
float32 kernel may cut a long key walk into pieces that run on separate
blocks and are merged in a fixed order; :func:`f32_plan` chooses the cut
from the shapes and masks alone, never from B or the card, so a row's bits
do not depend on the batch it runs in. Forward only: serving has no
backward, and the training slice adds one.

On a CUDA tensor the wrapper launches the kernel or raises. On a CPU
tensor it runs the plain version, :func:`repro_torch.kernels.ref.
flash_attention_ref`, and only because the tensor lies on the CPU. The
same checks apply on both devices, so the CPU tests see what the kernel
would refuse.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import ref as _ref

__all__ = ["flash_attention_fwd", "f32_plan", "MAX_HEAD_DIM", "PATHS"]

MAX_HEAD_DIM = 256  # the C side's MAX_D in csrc/flash_attention_fwd.cu
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_YZ = 65535
#: the kernel that serves each dtype, both on the tensor cores: wgmma (bfloat16) and
#: mma.sync in 3xTF32 (float32)
PATHS = {torch.bfloat16: "wgmma", torch.float32: "3xtf32"}
_TMA_ALIGN = 8  # head dims of the wgmma path: a TMA row stride is a multiple of 16 bytes

# The float32 kernel's tiles and split plan (``f32`` in csrc/flash_attention_fwd.cu).
F32_BLOCK_Q = 64  # query rows a block
#: a (batch, head) with fewer query tiles than this has its long key walks cut into pieces
F32_SPLIT_TARGET = 80
F32_MIN_PIECE_TILES = 2  # key tiles a piece, at least
F32_MAX_PIECES = 16  # pieces a query tile, at most (the merge kernel's weights)


def f32_key_block(d: int, dv: int) -> int:
    """Keys a tile of the float32 kernel: 64 (Q in registers) up to head dims of 64, else 16."""
    return 64 if d <= 64 and dv <= 64 else 16


def _f32_key_tiles(sq: int, sk: int, causal: bool, window: int, bk: int):
    """Key tiles each query tile walks: those some row of it can see (``Walk::key_tiles``)."""
    offset, tiles = sk - sq, []
    for q0 in range(0, sq, F32_BLOCK_Q):
        first, last = q0 + offset, min(q0 + F32_BLOCK_Q, sq) - 1 + offset
        k_end = min(sk, last + 1) if causal else sk
        k_begin = (max(0, first - window + 1) if window > 0 else 0) // bk * bk
        tiles.append(-(-(k_end - k_begin) // bk))
    return tiles


@functools.lru_cache(maxsize=1024)
def f32_plan(
    sq: int, sk: int, causal: bool, window: Optional[int], d: int, dv: int
) -> Tuple[int, int]:
    """(key tiles a piece, pieces of all query tiles) for the float32 kernel.

    A function of the shapes and masks of one (batch, head) alone: never of B, of the
    head count or of the card, so the reduction order of a row, and with it its bits,
    is the same at any batch. A (batch, head) with at least ``F32_SPLIT_TARGET`` query
    tiles is not cut. Below that, the longest walk is cut into about
    ``F32_SPLIT_TARGET / tiles`` pieces (at most ``F32_MAX_PIECES``, each of at least
    ``F32_MIN_PIECE_TILES`` key tiles) and every walk into pieces of that length, split
    evenly; the pieces of a tile are merged in order by a second kernel.
    """
    tiles = _f32_key_tiles(sq, sk, bool(causal), window or 0, f32_key_block(d, dv))
    longest = max(tiles)
    if len(tiles) >= F32_SPLIT_TARGET:
        split = longest
    else:
        pieces = min(F32_MAX_PIECES, -(-F32_SPLIT_TARGET // len(tiles)))
        split = max(F32_MIN_PIECE_TILES, -(-longest // pieces))
    return split, sum(-(-n // split) for n in tiles)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention_fwd: q, k, v must be 4-D (B, H, S, D)")
    b, hq, sq, d = q.shape
    bk, hkv, sk, dk = k.shape
    dv = v.shape[-1]
    if bk != b or v.shape[:3] != k.shape[:3] or dk != d:
        raise ValueError(
            f"flash_attention_fwd: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
            f"v{tuple(v.shape)} do not agree"
        )
    if hkv < 1 or hq % hkv:
        raise ValueError(f"flash_attention_fwd: Hq={hq} is not a multiple of Hkv={hkv}")
    if not (1 <= d <= MAX_HEAD_DIM and 1 <= dv <= MAX_HEAD_DIM):
        raise ValueError(f"flash_attention_fwd: head dims D={d}, Dv={dv} not in 1..{MAX_HEAD_DIM}")
    if sk < 1:
        raise ValueError("flash_attention_fwd: no keys (Sk = 0)")
    if (causal or window is not None) and sq > sk:
        raise ValueError(f"flash_attention_fwd: causal/window masks need Sq <= Sk, not {sq} > {sk}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_fwd: window must be >= 1, got {window}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention_fwd: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
            "all three must be float32 or all bfloat16"
        )
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_fwd: q, k, v must be contiguous")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention_fwd: q, k, v on different devices")
    if hq > _MAX_GRID_YZ or b > _MAX_GRID_YZ:
        raise ValueError(f"flash_attention_fwd: B={b}, Hq={hq} exceed the grid limit")


def _pad_head_dims(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q, k, v with D and Dv padded with zeros to multiples of 8, for the wgmma path.

    Zero q and k columns leave every score as it was; zero v columns give output
    columns that the caller cuts off. Tensors that need no pad come back as they
    are (a copy only where a base address is not 16-byte aligned, as TMA needs).
    """

    def pad(x: torch.Tensor) -> torch.Tensor:
        extra = -x.shape[-1] % _TMA_ALIGN
        if extra:
            return torch.nn.functional.pad(x, (0, extra))
        return x if x.data_ptr() % 16 == 0 else x.clone()

    return pad(q), pad(k), pad(v)


def _lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.load("flash_attention_fwd")
    fn = lib.repro_flash_attention_fwd
    if fn.argtypes is None:  # first use: declare the C signature
        fn.restype = ctypes.c_int
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 5 + [i32] * 9 + [ctypes.c_float] + [i32] * 3 + [ptr]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention forward. q (B,Hq,Sq,D), k (B,Hkv,Sk,D), v (B,Hkv,Sk,Dv) -> (B,Hq,Sq,Dv).

    ``flash_attention_fwd.launches`` counts kernel launches (never the CPU path);
    :data:`PATHS` names the kernel that serves each dtype.
    """
    _check(q, k, v, causal, window)
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return _ref.flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: no kernel for device {q.device}")
    tensor_cores = PATHS[q.dtype] == "wgmma"
    dv_out = v.shape[-1]
    if tensor_cores:
        q, k, v = _pad_head_dims(q, k, v)
    b, hq, sq, d = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[-1]
    out = torch.empty((b, hq, sq, dv), dtype=q.dtype, device=q.device)
    split_tiles, n_items, workspace = 0, 0, None
    if not tensor_cores and sq > 0 and b > 0:
        split_tiles, n_items = f32_plan(sq, sk, causal, window, d, dv)
        if n_items > -(-sq // F32_BLOCK_Q):  # some walk is cut: room for the pieces
            n = b * hq * n_items * F32_BLOCK_Q * (-(-dv // 8) * 8 + 2)
            workspace = torch.empty(n, dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention_fwd(
            q.data_ptr(),
            k.data_ptr(),
            v.data_ptr(),
            out.data_ptr(),
            None if workspace is None else workspace.data_ptr(),
            b,
            hq,
            hkv,
            sq,
            sk,
            d,
            dv,
            int(bool(causal)),
            int(window) if window is not None else 0,
            scale,
            split_tiles,
            n_items,
            int(tensor_cores),
            stream,
        )
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"flash_attention_fwd: launch failed: CUDA error {err} ({msg})")
    flash_attention_fwd.launches += 1
    return out if dv == dv_out else out[..., :dv_out].contiguous()


flash_attention_fwd.launches = 0
