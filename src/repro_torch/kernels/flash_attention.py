"""Flash-attention forward: the hand-written Hopper kernels and their wrapper.

Counterpart of ``repro.kernels.flash_attention.flash_attention_pallas``.
The kernels are in ``csrc/flash_attention_fwd.cu`` (CUDA C++ for
``sm_90a``, built by :mod:`._build`); its source note says what they
replace and what bounds them. bfloat16 runs on the tensor cores
(``wgmma`` fed by TMA), float32 on the CUDA cores (FMA): one kernel a
dtype, no fallback between them. Forward only: serving has no backward,
and the training slice adds one.

On a CUDA tensor the wrapper launches the kernel or raises. On a CPU
tensor it runs the plain version, :func:`repro_torch.kernels.ref.
flash_attention_ref`, and only because the tensor lies on the CPU. The
same checks apply on both devices, so the CPU tests see what the kernel
would refuse.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import ref as _ref

__all__ = ["flash_attention_fwd", "MAX_HEAD_DIM", "PATHS"]

MAX_HEAD_DIM = 256  # the C side's MAX_D in csrc/flash_attention_fwd.cu
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_YZ = 65535
#: the kernel that serves each dtype: tensor cores (wgmma) or CUDA cores (FMA)
PATHS = {torch.bfloat16: "wgmma", torch.float32: "fma"}
_TMA_ALIGN = 8  # head dims of the wgmma path: a TMA row stride is a multiple of 16 bytes


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
        fn.argtypes = [ptr] * 4 + [i32] * 9 + [ctypes.c_float, i32, ptr]
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
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention_fwd(
            q.data_ptr(),
            k.data_ptr(),
            v.data_ptr(),
            out.data_ptr(),
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
            int(tensor_cores),
            stream,
        )
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"flash_attention_fwd: launch failed: CUDA error {err} ({msg})")
    flash_attention_fwd.launches += 1
    return out if dv == dv_out else out[..., :dv_out].contiguous()


flash_attention_fwd.launches = 0
