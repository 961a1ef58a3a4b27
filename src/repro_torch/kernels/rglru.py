"""RG-LRU scan: the hand-written Hopper kernel and its wrapper.

Counterpart of ``repro.kernels.rglru.rglru_pallas``. The kernel is
``csrc/rglru_scan.cu`` (CUDA C++ for ``sm_90a``, built by :mod:`._build`);
its source note says what it replaces and what bounds it.

On a CUDA tensor the wrapper launches the kernel or raises. On a CPU
tensor it runs the plain version, :func:`repro_torch.kernels.ref.rglru_ref`,
and only because the tensor lies on the CPU. The same checks apply on both
devices, so the CPU tests see what the kernel would refuse.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import ref as _ref

__all__ = ["rglru_scan"]

_X_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_Y = 65535


def _check(x: torch.Tensor, a: torch.Tensor, h0: Optional[torch.Tensor]) -> None:
    if x.dim() != 3 or a.shape != x.shape:
        raise ValueError(
            f"rglru_scan: x {tuple(x.shape)} and a {tuple(a.shape)} must both be (B, T, W)"
        )
    b, t, w = x.shape
    if t < 1 or w < 1:
        raise ValueError(f"rglru_scan: empty time or channel axis in {tuple(x.shape)}")
    if x.dtype not in _X_DTYPES:
        raise TypeError(f"rglru_scan: x is {x.dtype}; it must be float32 or bfloat16")
    if a.dtype != torch.float32:
        raise TypeError(f"rglru_scan: a is {a.dtype}; it must be float32")
    if h0 is not None:
        if h0.shape != (b, w):
            raise ValueError(f"rglru_scan: initial_state {tuple(h0.shape)}, expected {(b, w)}")
        if h0.dtype != torch.float32:
            raise TypeError(f"rglru_scan: initial_state is {h0.dtype}; it must be float32")
    tensors = (x, a) if h0 is None else (x, a, h0)
    if not all(t_.is_contiguous() for t_ in tensors):
        raise ValueError("rglru_scan: x, a and initial_state must be contiguous")
    if any(t_.device != x.device for t_ in tensors):
        raise ValueError("rglru_scan: x, a and initial_state on different devices")
    if b > _MAX_GRID_Y:
        raise ValueError(f"rglru_scan: B={b} exceeds the grid limit")


def _lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.load("rglru_scan")
    fn = lib.repro_rglru_scan
    if fn.argtypes is None:  # first use: declare the C signature
        fn.restype = ctypes.c_int
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def rglru_scan(
    x: torch.Tensor, a: torch.Tensor, *, initial_state: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,T,W) float32|bfloat16, a (B,T,W) float32, initial_state (B,W) float32
    -> (h (B,T,W) in x's dtype, final state (B,W) float32).

    ``rglru_scan.launches`` counts kernel launches (never the CPU path).
    """
    _check(x, a, initial_state)
    if x.device.type == "cpu":
        return _ref.rglru_ref(x, a, initial_state=initial_state)
    if x.device.type != "cuda":
        raise ValueError(f"rglru_scan: no kernel for device {x.device}")
    b, t, w = x.shape
    h = torch.empty_like(x)
    h_last = torch.empty((b, w), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_rglru_scan(
            x.data_ptr(),
            a.data_ptr(),
            initial_state.data_ptr() if initial_state is not None else None,
            h.data_ptr(),
            h_last.data_ptr(),
            b,
            t,
            w,
            int(x.dtype == torch.bfloat16),
            stream,
        )
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"rglru_scan: launch failed: CUDA error {err} ({msg})")
    rglru_scan.launches += 1
    return h, h_last


rglru_scan.launches = 0
