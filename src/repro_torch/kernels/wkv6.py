"""RWKV6 WKV: the hand-written Hopper kernels and their wrapper.

Counterpart of ``repro.kernels.rwkv6.wkv6_pallas``. The kernels are in
``csrc/wkv6.cu`` (CUDA C++ for ``sm_90a``, built by :mod:`._build`); its
source note says what they replace and what bounds them. Two launch shapes,
picked by T alone (:func:`path_for`): the chunk kernel (a pipelined walk over
16-row chunks, S in registers) for prefill, and the stream kernel (S read
once, stepped through the rows, written once) for T <= :data:`STREAM_MAX_T`,
decode's T = 1 included.

The kernels take r, k, v, w by strides with the last axis contiguous, so the
model's ``(B, T, H, K)`` projections seen as ``(B, H, T, K)`` go in without
a copy. They write the output in ``(B, T, H, V)`` memory order and the
wrapper returns it as the ``(B, H, T, V)`` view, which the model turns back
into ``(B, T, H*V)`` for free. The chunk kernel's 16-byte copies need r, k,
v, w 16-byte aligned with strides of whole 16 bytes; an operand that is not
(a K or V that is no multiple of 8 in bfloat16, a view at an odd offset) is
padded first, as the flash wrapper pads head dims.

The gradient is :func:`wkv6_bwd`, the kernels of ``csrc/wkv6_bwd.cu`` (two
walks over the chunks, split by state columns, write the chunk-start states
and the gradients of the chunk-end states into a float32 scratch; then a block
a chunk computes every chunk's gradients on the tensor cores; then du), and
:class:`WKV6Function` puts the two together under autograd. It returns dr, dk,
dv and dw as ``(B, H, T, .)`` views of fresh ``(B, T, H, .)`` tensors, the
layout the model's projections have. Its 16-byte copies need the operands
aligned as the chunk kernel's do, and the wrapper pads them the same way.

On a CUDA tensor a wrapper launches its kernel or raises. On a CPU tensor it
runs the plain version, :func:`repro_torch.kernels.ref.wkv6_chunked_ref` or
:func:`repro_torch.kernels.ref.wkv6_bwd_ref`, and only because the tensor
lies on the CPU. The same checks apply on both devices, so the CPU tests see
what the kernel would refuse.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import ref as _ref
from ._build import count_launch

__all__ = [
    "wkv6_chunked",
    "wkv6_bwd",
    "WKV6Function",
    "path_for",
    "CHUNK",
    "MAX_HEAD_SIZE",
    "STREAM_MAX_T",
]

CHUNK = 16
MAX_HEAD_SIZE = 64
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_YZ = 65535
#: the longest T that the stream kernel serves; longer T goes to the chunk kernel. On an
#: H100 at the decode batch (4, 64, T, 64) the stream kernel takes less device time than the
#: chunk kernel up to T = 8 and more from T = 16 (``tools/wkv6_check.py`` times both), but it
#: steps row by row where the plain version factors a chunk, and its float32 output drifts
#: from the plain version's with T (at T = 4 by half the 2e-5 tolerance): 4 keeps a margin.
STREAM_MAX_T = 4
_C_PATH = {"chunk": 0, "stream": 1}


def path_for(t: int) -> str:
    """The kernel that serves a call of ``t`` rows, whatever B and H: "stream" or "chunk"."""
    return "stream" if t <= STREAM_MAX_T else "chunk"


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the chunk kernel's 16-byte copies need it: base address and (batch,
    head, time) strides in whole 16 bytes. An ``x`` that is not comes back padded
    with zeros along its last axis to a multiple of 16 bytes, contiguous; the
    kernel reads only the first K (or V) columns."""
    es = x.element_size()
    if x.data_ptr() % 16 == 0 and all(s * es % 16 == 0 for s in x.stride()[:3]):
        return x
    n = x.shape[-1]
    padded = x.new_zeros(*x.shape[:-1], n + (-n) % (16 // es))
    padded[..., :n] = x
    return padded


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
        # argtypes last: it is the flag another thread tests above
        fn.restype = ctypes.c_int
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        i64 = ctypes.c_longlong
        lib.repro_wkv6_shared_bytes.restype = ctypes.c_int
        lib.repro_wkv6_shared_bytes.argtypes = [i32]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        fn.argtypes = [ptr] * 8 + [ctypes.POINTER(i64), i32, i32, i64] + [i32] * 4 + [ptr]
    return lib


def _plan(r, k, v, w, initial_state):
    """What a launch hands the C entry point for these operands: the path's code, r, k,
    v, w and the initial state as the chosen kernel takes them, the output (a (B, H, T,
    V) view of (B, T, H, V) memory), the final state and the 15 strides."""
    b, h, t, kd = r.shape
    vd = v.shape[-1]
    path = path_for(t)
    if path == "chunk":
        r, k, v, w = (_aligned(x) for x in (r, k, v, w))
    elif initial_state is not None and initial_state.data_ptr() % 16:
        initial_state = initial_state.clone()  # the stream kernel's 16-byte state loads
    out = torch.empty((b, t, h, vd), dtype=r.dtype, device=r.device).transpose(1, 2)
    s_out = torch.empty((b, h, kd, vd), dtype=torch.float32, device=r.device)
    strides = [s for x in (r, k, v, w, out) for s in x.stride()[:3]]
    return _C_PATH[path], (r, k, v, w, initial_state, out, s_out), strides


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

    ``wkv6_chunked.launches`` counts kernel launches (never the CPU path);
    :func:`path_for` names the kernel that serves a T.
    """
    _check(r, k, v, w, u, initial_state)
    if r.device.type == "cpu":
        return _ref.wkv6_chunked_ref(r, k, v, w, u, chunk=CHUNK, initial_state=initial_state)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6: no kernel for device {r.device}")
    b, h, t, kd = r.shape
    vd = v.shape[-1]
    code, (r, k, v, w, initial_state, out, s_out), strides = _plan(r, k, v, w, initial_state)
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
            code,
            stream,
        )
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"wkv6: launch failed: CUDA error {err} ({msg})")
    count_launch(wkv6_chunked)
    return out, s_out


wkv6_chunked.launches = 0


def _bwd_lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.load("wkv6_bwd")
    fn = lib.repro_wkv6_bwd
    if fn.argtypes is None:  # first use: declare the C signature
        # argtypes last: it is the flag another thread tests above
        fn.restype = ctypes.c_int
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.repro_wkv6_bwd_shared_bytes.restype = ctypes.c_int
        lib.repro_wkv6_bwd_shared_bytes.argtypes = [i32, i32]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        fn.argtypes = [ptr] * 16 + [ctypes.POINTER(i64), i32, i32, i64] + [i32] * 3 + [ptr]
    return lib


def _check_grads(r, v, dout, ds_last) -> None:
    b, h, _, kd = r.shape
    vd = v.shape[-1]
    if dout.shape != v.shape or dout.dtype != r.dtype or dout.stride(-1) != 1:
        raise ValueError(
            f"wkv6_bwd: dout {tuple(dout.shape)} {dout.dtype} must be shaped as v "
            f"{tuple(v.shape)}, in r's dtype {r.dtype}, its last axis contiguous"
        )
    if ds_last is not None and (
        ds_last.shape != (b, h, kd, vd)
        or ds_last.dtype != torch.float32
        or not ds_last.is_contiguous()
    ):
        raise ValueError(
            f"wkv6_bwd: ds_last {tuple(ds_last.shape)} must be ({b}, {h}, {kd}, {vd}) float32, "
            "contiguous"
        )
    if any(g.device != r.device for g in (dout, ds_last) if g is not None):
        raise ValueError("wkv6_bwd: the gradients lie on another device than r")


def _fresh(b, t, h, n, dtype, device) -> torch.Tensor:
    """A (B, H, T, n) view of new (B, T, H, n) memory: the model's layout."""
    return torch.empty((b, t, h, n), dtype=dtype, device=device).transpose(1, 2)


def wkv6_bwd(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    dout: torch.Tensor,
    *,
    initial_state: Optional[torch.Tensor] = None,
    ds_last: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """The gradient of :func:`wkv6_chunked`: from its operands (as it takes them), ``dout``
    (B,H,T,V) in r's dtype and ``ds_last`` (B,H,K,V) float32 or None (zero), returns (dr,
    dk, dv in r's dtype, dw float32, du (H,K) in u's dtype, dS0 (B,H,K,V) float32, or None
    when ``initial_state`` is None).

    ``wkv6_bwd.launches`` counts calls that launched the kernels (never the CPU path). They
    write the chunk-start states and the chunk-end state gradients into a float32 scratch of
    2 x (B, H, ceil(T/16), K, V rounded up to 4) of their own.
    """
    _check(r, k, v, w, u, initial_state)
    _check_grads(r, v, dout, ds_last)
    if r.device.type == "cpu":
        grads = _ref.wkv6_bwd_ref(
            r, k, v, w, u, dout, initial_state=initial_state, ds_last=ds_last, chunk=CHUNK
        )
        return grads[:5] + (grads[5] if initial_state is not None else None,)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6_bwd: no kernel for device {r.device}")
    b, h, t, kd = r.shape
    vd = v.shape[-1]
    dev = r.device
    r, k, v, w, dout = (_aligned(x) for x in (r, k, v, w, dout))
    dr, dk, dw = (_fresh(b, t, h, kd, dt, dev) for dt in (r.dtype, r.dtype, torch.float32))
    dv = _fresh(b, t, h, vd, r.dtype, dev)
    du = torch.empty((h, kd), dtype=u.dtype, device=dev)
    n_chunks = -(-t // CHUNK)
    du_part = torch.empty((b, h, n_chunks, kd), dtype=torch.float32, device=dev)
    ds0 = None
    if initial_state is not None:
        ds0 = torch.empty((b, h, kd, vd), dtype=torch.float32, device=dev)
    vp = -(-vd // 4) * 4
    states = torch.empty((2, b, h, n_chunks, kd, vp), dtype=torch.float32, device=dev)
    strides = [s for x in (r, k, v, w, dout, dr, dk, dv, dw) for s in x.stride()[:3]]
    lib = _bwd_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_wkv6_bwd(
            r.data_ptr(),
            k.data_ptr(),
            v.data_ptr(),
            w.data_ptr(),
            u.data_ptr(),
            initial_state.data_ptr() if initial_state is not None else None,
            dout.data_ptr(),
            ds_last.data_ptr() if ds_last is not None else None,
            states.data_ptr(),
            dr.data_ptr(),
            dk.data_ptr(),
            dv.data_ptr(),
            dw.data_ptr(),
            du_part.data_ptr(),
            du.data_ptr(),
            ds0.data_ptr() if ds0 is not None else None,
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
        raise RuntimeError(f"wkv6_bwd: launch failed: CUDA error {err} ({msg})")
    count_launch(wkv6_bwd)
    return dr, dk, dv, dw, du, ds0


wkv6_bwd.launches = 0


class WKV6Function(torch.autograd.Function):
    """The WKV with its gradient: :func:`wkv6_chunked` forward with r, k, v, w, u and the
    initial state saved, :func:`wkv6_bwd` backward. ``initial_state`` may be None."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, initial_state):
        out, s = wkv6_chunked(r, k, v, w, u, initial_state=initial_state)
        ctx.save_for_backward(r, k, v, w, u, initial_state)
        return out, s

    @staticmethod
    def backward(ctx, dout, ds_last):
        r, k, v, w, u, initial_state = ctx.saved_tensors
        if dout.stride(-1) != 1:  # the kernel takes any (batch, head, time) strides
            dout = dout.contiguous()
        return wkv6_bwd(
            r, k, v, w, u, dout, initial_state=initial_state, ds_last=ds_last.contiguous()
        )
