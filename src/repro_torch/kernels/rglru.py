"""RG-LRU scan: the hand-written Hopper kernels and their wrapper.

Counterpart of ``repro.kernels.rglru.rglru_pallas``. The kernels are in
``csrc/rglru_scan.cu`` (CUDA C++ for ``sm_90a``, built by :mod:`._build`);
its source note says what they replace and what bounds them. Two launch
shapes, picked by T alone (:func:`path_for`): the ring kernel (a block per
batch row and :data:`RING_CHANNELS` channels, fed by a ring of ``cp.async``
stages) for prefill, and the step kernel (a thread a channel) for
T <= :data:`STEP_MAX_T`, decode's T = 1 included. Both walk each channel's
steps in order with the plain version's rounding: the same bits as
:func:`repro_torch.kernels.ref.rglru_ref`.

The ring kernel's 16-byte copies need W a multiple of 8 and x, a 16-byte
aligned; the wrapper pads W with zeros (a = 0, x = 0 keep h = 0 there) when
they are not, as the flash wrapper pads head dims.

The gradient is :func:`rglru_bwd`, two more ring kernels in
``csrc/rglru_bwd.cu`` (the forward's float32 states re-walked into a scratch,
then every channel walked back through time; bit for bit
:func:`repro_torch.kernels.ref.rglru_bwd_ref`), whose W the wrapper pads as
the ring kernel's; :class:`RGLRUFunction` joins the forward and it under
autograd.

On a CUDA tensor each wrapper launches its kernel or raises. On a CPU
tensor it runs the plain version (:func:`repro_torch.kernels.ref.rglru_ref`,
:func:`~repro_torch.kernels.ref.rglru_bwd_ref`), and only because the tensor
lies on the CPU. The same checks apply on both devices, so the CPU tests see
what the kernels would refuse.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import ref as _ref
from ._build import count_launch

__all__ = [
    "rglru_scan",
    "rglru_bwd",
    "RGLRUFunction",
    "path_for",
    "RING_CHANNELS",
    "STEP_MAX_T",
]

_X_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_Y = 65535
#: channels a ring-kernel block (``CH`` in the source): its grid is (ceil(W / 16), B)
RING_CHANNELS = 16
#: the longest T that the step kernel serves; longer T goes to the ring kernel. On an H100
#: at (1, T, 4096) bfloat16 the step kernel takes less device time up to T = 32 and more
#: from T = 48 (``tools/rglru_check.py`` times both); decode's T = 1 is far inside.
STEP_MAX_T = 32
_C_PATH = {"ring": 0, "step": 1}


def path_for(t: int) -> str:
    """The kernel that serves a call of ``t`` steps, whatever B and W: "step" or "ring"."""
    return "step" if t <= STEP_MAX_T else "ring"


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


def _lib(name: str = "rglru_scan", n_ptr: int = 5, n_int: int = 5) -> ctypes.CDLL:
    """Kernel library ``name``, its entry point ``repro_<name>`` declared as n_ptr pointers,
    n_int ints and the stream."""
    from . import _build

    lib = _build.load(name)
    fn = getattr(lib, f"repro_{name}")
    if fn.argtypes is None:  # first use: declare the C signature
        # argtypes last: it is the flag another thread tests above
        fn.restype = ctypes.c_int
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        fn.argtypes = [ptr] * n_ptr + [i32] * n_int + [ptr]
    return lib


def _plan(x, a, h0):
    """What a launch hands the C entry point: the path's code and x, a and the initial
    state as the chosen kernel takes them. For the ring kernel, operands whose W is no
    multiple of 8 or whose address is no multiple of 16 bytes come back padded with
    zeros along W to a multiple of 8, contiguous; the caller keeps the first W channels."""
    w = x.shape[2]
    path = path_for(x.shape[1])
    if path == "ring" and (w % 8 or x.data_ptr() % 16 or a.data_ptr() % 16):
        wp = w + (-w) % 8
        x, a = _padded(x, wp), _padded(a, wp)
        h0 = None if h0 is None else _padded(h0, wp)
    return _C_PATH[path], x, a, h0


def _padded(y: torch.Tensor, width: int) -> torch.Tensor:
    out = y.new_zeros(*y.shape[:-1], width)
    out[..., : y.shape[-1]] = y
    return out


def rglru_scan(
    x: torch.Tensor, a: torch.Tensor, *, initial_state: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,T,W) float32|bfloat16, a (B,T,W) float32, initial_state (B,W) float32
    -> (h (B,T,W) in x's dtype, final state (B,W) float32).

    ``rglru_scan.launches`` counts kernel launches (never the CPU path);
    :func:`path_for` names the kernel that serves a T.
    """
    _check(x, a, initial_state)
    if x.device.type == "cpu":
        return _ref.rglru_ref(x, a, initial_state=initial_state)
    if x.device.type != "cuda":
        raise ValueError(f"rglru_scan: no kernel for device {x.device}")
    w = x.shape[2]
    code, x, a, initial_state = _plan(x, a, initial_state)
    b, t, wp = x.shape
    h = torch.empty_like(x)
    h_last = torch.empty((b, wp), dtype=torch.float32, device=x.device)
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
            wp,
            int(x.dtype == torch.bfloat16),
            code,
            stream,
        )
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"rglru_scan: launch failed: CUDA error {err} ({msg})")
    count_launch(rglru_scan)
    if wp != w:
        return h[..., :w].contiguous(), h_last[:, :w].contiguous()
    return h, h_last


rglru_scan.launches = 0


def rglru_bwd(
    x: torch.Tensor,
    a: torch.Tensor,
    dh: torch.Tensor,
    *,
    initial_state: Optional[torch.Tensor] = None,
    dh_last: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of :func:`rglru_scan`: from x, a, initial_state, ``dh`` (B,T,W) in x's
    dtype and ``dh_last`` (B,W) float32 or None, returns (dx in x's dtype, da float32,
    dh0 (B,W) float32).

    ``rglru_bwd.launches`` counts calls that launched the kernels (never the CPU path). They
    recompute the forward's float32 states into a (B,T,W) float32 scratch of their own.
    """
    _check(x, a, initial_state)
    b, t, w = x.shape
    if dh.shape != x.shape or dh.dtype != x.dtype or not dh.is_contiguous():
        raise ValueError(
            f"rglru_bwd: dh {tuple(dh.shape)} {dh.dtype} must be contiguous, shaped and typed "
            f"as x {tuple(x.shape)} {x.dtype}"
        )
    if dh_last is not None and (
        dh_last.shape != (b, w) or dh_last.dtype != torch.float32 or not dh_last.is_contiguous()
    ):
        raise ValueError(f"rglru_bwd: dh_last {tuple(dh_last.shape)} must be ({b}, {w}) float32")
    if any(g.device != x.device for g in (dh, dh_last) if g is not None):
        raise ValueError("rglru_bwd: the gradients lie on another device than x")
    if x.device.type == "cpu":
        return _ref.rglru_bwd_ref(x, a, dh, initial_state=initial_state, dh_last=dh_last)
    if x.device.type != "cuda":
        raise ValueError(f"rglru_bwd: no kernel for device {x.device}")
    given = [g for g in (x, a, dh, initial_state, dh_last) if g is not None]
    wp = w + (-w) % 8  # the ring kernels' 16-byte copies: W padded with zeros, as _plan pads
    if wp != w or any(g.data_ptr() % 16 for g in given):
        x, a, dh = (_padded(g, wp) for g in (x, a, dh))
        initial_state = None if initial_state is None else _padded(initial_state, wp)
        dh_last = None if dh_last is None else _padded(dh_last, wp)
    dx = torch.empty_like(x)
    da = torch.empty_like(a)
    dh0 = torch.empty((b, wp), dtype=torch.float32, device=x.device)
    states = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    lib = _lib("rglru_bwd", 9, 4)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_rglru_bwd(
            x.data_ptr(),
            a.data_ptr(),
            initial_state.data_ptr() if initial_state is not None else None,
            dh.data_ptr(),
            dh_last.data_ptr() if dh_last is not None else None,
            states.data_ptr(),
            dx.data_ptr(),
            da.data_ptr(),
            dh0.data_ptr(),
            b,
            t,
            wp,
            int(x.dtype == torch.bfloat16),
            stream,
        )
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"rglru_bwd: launch failed: CUDA error {err} ({msg})")
    count_launch(rglru_bwd)
    if wp != w:
        return dx[..., :w].contiguous(), da[..., :w].contiguous(), dh0[:, :w].contiguous()
    return dx, da, dh0


rglru_bwd.launches = 0


class RGLRUFunction(torch.autograd.Function):
    """The RG-LRU with its gradient: :func:`rglru_scan` forward with x, a and the initial
    state saved, :func:`rglru_bwd` backward. ``initial_state`` may be None."""

    @staticmethod
    def forward(ctx, x, a, initial_state):
        h, h_last = rglru_scan(x, a, initial_state=initial_state)
        ctx.save_for_backward(x, a, initial_state)
        return h, h_last

    @staticmethod
    def backward(ctx, dh, dh_last):
        x, a, initial_state = ctx.saved_tensors
        dx, da, dh0 = rglru_bwd(
            x,
            a,
            dh.contiguous(),
            initial_state=initial_state,
            dh_last=dh_last.float().contiguous(),
        )
        return dx, da, dh0 if initial_state is not None else None
