"""Public kernel ops: dispatch by the device of the tensors.

Counterpart of ``repro.kernels.ops``. Models import only from this module.

  impl="auto" or "pallas" : the Hopper kernel on a CUDA tensor, its plain
                            version (``ref.flash_attention_ref``,
                            ``ref.decode_attention_ref``,
                            ``ref.wkv6_chunked_ref``, ``ref.rglru_ref``) on a
                            CPU tensor; "pallas" is accepted so that the
                            reference's ``cfg.attn_impl`` values carry over.
                            Attention whose inputs need a gradient goes
                            through ``FlashAttentionFunction``: the forward
                            kernel saves the logsumexp and the backward
                            kernels (plain versions on the CPU) give the
                            gradient; the RG-LRU and the WKV6 likewise
                            through ``RGLRUFunction`` and ``WKV6Function``
                            and their backward kernels
  impl="ref"              : the blocked attention / cached decode / chunked
                            WKV6 / associative-scan RG-LRU plain version on
                            any device (its gradient by plain autograd)
  impl="dense"            : the O(S²) dense attention oracle (small test
                            shapes only) / the cached decode's plain version
                            (it has one) / the sequential WKV6 / the
                            sequential RG-LRU
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import ref as _ref
from .decode_attention import decode_attention as _decode_attention_kernel
from .flash_attention import FlashAttentionFunction, flash_attention_fwd
from .rglru import RGLRUFunction, rglru_scan
from .wkv6 import CHUNK as _WKV_CHUNK
from .wkv6 import WKV6Function, wkv6_chunked

__all__ = ["flash_attention", "decode_attention", "wkv6", "rglru"]


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Causal/local GQA attention. q (B,Hq,Sq,D), k/v (B,Hkv,Sk,D|Dv) -> (B,Hq,Sq,Dv)."""
    if impl in ("auto", "pallas"):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            return FlashAttentionFunction.apply(q, k, v, causal, window, scale)
        return flash_attention_fwd(q, k, v, causal=causal, window=window, scale=scale)
    if impl == "ref":
        return _ref.flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    if impl == "dense":
        return _ref.flash_attention_dense_ref(q, k, v, causal=causal, window=window, scale=scale)
    raise ValueError(f"unknown attention impl {impl!r}")


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos: torch.Tensor,
    *,
    window: Optional[int] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """One decode step of GQA attention. q (B,H,D), caches (B,Sc,KV,D), pos (B,) int32
    -> (B,H,D); a cache of ``window`` slots is a ring. The caller has written this
    step's key and value at each slot's position."""
    if impl in ("auto", "pallas"):
        return _decode_attention_kernel(q, k_cache, v_cache, pos, window=window)
    if impl in ("ref", "dense"):
        return _ref.decode_attention_ref(q, k_cache, v_cache, pos, window=window)
    raise ValueError(f"unknown decode attention impl {impl!r}")


def wkv6(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    *,
    initial_state: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV6 'Finch' WKV. r, k, w (B,H,T,K), v (B,H,T,V), u (H,K) -> (out (B,H,T,V),
    state (B,H,K,V) float32). Callers keep log(w) >= -4 per step (ref.wkv6_chunked_ref)."""
    if impl in ("auto", "pallas"):
        inputs = (r, k, v, w, u) if initial_state is None else (r, k, v, w, u, initial_state)
        if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
            return WKV6Function.apply(r, k, v, w, u, initial_state)
        return wkv6_chunked(r, k, v, w, u, initial_state=initial_state)
    if impl == "ref":
        return _ref.wkv6_chunked_ref(r, k, v, w, u, chunk=_WKV_CHUNK, initial_state=initial_state)
    if impl == "dense":
        return _ref.wkv6_ref(r, k, v, w, u, initial_state=initial_state)
    raise ValueError(f"unknown wkv6 impl {impl!r}")


def rglru(
    x: torch.Tensor,
    a: torch.Tensor,
    *,
    initial_state: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RG-LRU h_t = a_t h_{t-1} + sqrt(1 - a_t²) x_t. x, a (B,T,W) -> (h, final state (B,W))."""
    if impl in ("auto", "pallas"):
        inputs = (x, a) if initial_state is None else (x, a, initial_state)
        if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
            return RGLRUFunction.apply(x, a, initial_state)
        return rglru_scan(x, a, initial_state=initial_state)
    if impl == "ref":
        return _ref.rglru_scan_ref(x, a, initial_state=initial_state)
    if impl == "dense":
        return _ref.rglru_ref(x, a, initial_state=initial_state)
    raise ValueError(f"unknown rglru impl {impl!r}")
