"""RWKV6 WKV: the hand-written Hopper kernel and its wrapper.

Counterpart of ``repro.kernels.rwkv6.wkv6_pallas``. The kernel is
``csrc/wkv6.cu`` (CUDA C++ for ``sm_90a``, built by :mod:`._build`); its
source note says what it replaces and what bounds it.

The kernel takes r, k, v, w by strides with the last axis contiguous, so the
model's ``(B, T, H, K)`` projections seen as ``(B, H, T, K)`` go in without
a copy. It writes the output in ``(B, T, H, V)`` memory order and the
wrapper returns it as the ``(B, H, T, V)`` view, which the model turns back
into ``(B, T, H*V)`` for free. A last chunk shorter than 16 rows runs in
place (the reference's r = k = 0, w = 1 padding is a no-op), so any T >= 1
is taken, decode's T = 1 included.

On a CUDA tensor the wrapper launches the kernel or raises. On a CPU tensor
it runs the plain version, :func:`repro_torch.kernels.ref.wkv6_chunked_ref`,
and only because the tensor lies on the CPU. The same checks apply on both
devices, so the CPU tests see what the kernel would refuse.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import ref as _ref

__all__ = ["wkv6_chunked", "CHUNK", "MAX_HEAD_SIZE"]

CHUNK = 16
MAX_HEAD_SIZE = 64
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_YZ = 65535


def _check(r, k, v, w, u, s0) -> None:
    if r.dim() != 4 or k.shape != r.shape or w.shape != r.shape:
        raise ValueError(
            f"wkv6: r {tuple(r.shape)}, k {tuple(k.shape)} and w {tuple(w.shape)} "
            "must all be (B, H, T, K)"
        )
    b, h, t, kd = r.shape
    if v.dim() != 4 or v.shape[:3] != r.shape[:3]:
        raise ValueError(f"wkv6: v {tuple(v.shape)} must be (B, H, T, V) with r's (B, H, T)")
    vd = v.shape[-1]
    if t < 1 or b < 1 or h < 1:
        raise ValueError(f"wkv6: empty batch, head or time axis in {tuple(r.shape)}")
    if not (1 <= kd <= MAX_HEAD_SIZE and 1 <= vd <= MAX_HEAD_SIZE):
        raise ValueError(f"wkv6: K={kd}, V={vd}; the kernel takes 1..{MAX_HEAD_SIZE}")
    if r.dtype not in _DTYPES:
        raise TypeError(f"wkv6: r is {r.dtype}; it must be float32 or bfloat16")
    if k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"wkv6: r, k, v are {r.dtype}, {k.dtype}, {v.dtype}; they must agree")
    if w.dtype != torch.float32:
        raise TypeError(f"wkv6: w is {w.dtype}; it must be float32")
    if u.shape != (h, kd):
        raise ValueError(f"wkv6: u {tuple(u.shape)}, expected {(h, kd)}")
    if u.dtype != r.dtype:
        raise TypeError(f"wkv6: u is {u.dtype}; it must be r's dtype, {r.dtype}")
    if s0 is not None:
        if s0.shape != (b, h, kd, vd):
            raise ValueError(f"wkv6: initial_state {tuple(s0.shape)}, expected {(b, h, kd, vd)}")
        if s0.dtype != torch.float32:
            raise TypeError(f"wkv6: initial_state is {s0.dtype}; it must be float32")
        if not s0.is_contiguous():
            raise ValueError("wkv6: initial_state must be contiguous")
    if not u.is_contiguous():
        raise ValueError("wkv6: u must be contiguous")
    if any(x.stride(-1) != 1 for x in (r, k, v, w)):
        raise ValueError("wkv6: the last axis of r, k, v and w must be contiguous")
    tensors = (r, k, v, w, u) if s0 is None else (r, k, v, w, u, s0)
    if any(x.device != r.device for x in tensors):
        raise ValueError("wkv6: r, k, v, w, u and initial_state on different devices")
    if b > _MAX_GRID_YZ or h > _MAX_GRID_YZ:
        raise ValueError(f"wkv6: B={b} or H={h} exceeds the grid limit")


def _lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.load("wkv6")
    fn = lib.repro_wkv6
    if fn.argtypes is None:  # first use: declare the C signature
        fn.restype = ctypes.c_int
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 8 + [ctypes.POINTER(ctypes.c_longlong)] + [i32] * 6 + [ptr]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def wkv6_chunked(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    *,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k (B,H,T,K), v (B,H,T,V) and u (H,K) float32|bfloat16, w (B,H,T,K) float32
    (the decay multiplier in (0, 1]), initial_state (B,H,K,V) float32
    -> (out (B,H,T,V) in r's dtype, final state (B,H,K,V) float32).

    ``wkv6_chunked.launches`` counts kernel launches (never the CPU path).
    """
    _check(r, k, v, w, u, initial_state)
    if r.device.type == "cpu":
        return _ref.wkv6_chunked_ref(r, k, v, w, u, chunk=CHUNK, initial_state=initial_state)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6: no kernel for device {r.device}")
    b, h, t, kd = r.shape
    vd = v.shape[-1]
    out = torch.empty((b, t, h, vd), dtype=r.dtype, device=r.device).transpose(1, 2)
    s_out = torch.empty((b, h, kd, vd), dtype=torch.float32, device=r.device)
    strides = [s for x in (r, k, v, w, out) for s in x.stride()[:3]]
    lib = _lib()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.repro_wkv6(
            r.data_ptr(),
            k.data_ptr(),
            v.data_ptr(),
            w.data_ptr(),
            u.data_ptr(),
            initial_state.data_ptr() if initial_state is not None else None,
            out.data_ptr(),
            s_out.data_ptr(),
            (ctypes.c_longlong * len(strides))(*strides),
            b,
            h,
            t,
            kd,
            vd,
            int(r.dtype == torch.bfloat16),
            stream,
        )
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"wkv6: launch failed: CUDA error {err} ({msg})")
    wkv6_chunked.launches += 1
    return out, s_out


wkv6_chunked.launches = 0
