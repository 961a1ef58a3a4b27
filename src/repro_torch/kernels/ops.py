"""Public kernel ops: dispatch by the device of the tensors.

Counterpart of ``repro.kernels.ops``. Models import only from this module.

  impl="auto" or "pallas" : the Hopper kernel on a CUDA tensor, its plain
                            version (``ref.flash_attention_ref``) on a CPU
                            tensor; "pallas" is accepted so that the
                            reference's ``cfg.attn_impl`` values carry over
  impl="ref"              : the blocked plain version on any device
  impl="dense"            : the O(S²) dense oracle (small test shapes only)
"""

from __future__ import annotations

from typing import Optional

import torch

from . import ref as _ref
from .flash_attention import flash_attention_fwd

__all__ = ["flash_attention", "wkv6", "rglru"]


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
        return flash_attention_fwd(q, k, v, causal=causal, window=window, scale=scale)
    if impl == "ref":
        return _ref.flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    if impl == "dense":
        return _ref.flash_attention_dense_ref(q, k, v, causal=causal, window=window, scale=scale)
    raise ValueError(f"unknown attention impl {impl!r}")


def wkv6(*args, **kwargs):
    """RWKV6 WKV: not ported yet (ROADMAP Queue 2, item 3, ``_wkv6_kernel``)."""
    raise NotImplementedError("wkv6 is not ported yet: ROADMAP Queue 2 item 3 (_wkv6_kernel)")


def rglru(*args, **kwargs):
    """RG-LRU scan: not ported yet (ROADMAP Queue 2, item 4, ``_rglru_kernel``)."""
    raise NotImplementedError("rglru is not ported yet: ROADMAP Queue 2 item 4 (_rglru_kernel)")
