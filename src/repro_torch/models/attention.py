"""GQA attention: full-sequence (prefill) and cached decode, each through a kernel.

Counterpart of ``repro.models.attention`` (GQA only; MLA waits for its
slice). Two call modes:
  - full-sequence: ``ops.flash_attention`` (the Hopper kernel on the card);
  - cached decode: one token per sequence against a fixed-size cache with a
    per-sequence position, through ``ops.decode_attention``. The reference
    is plain jnp here; the port's kernel gives a sequence the same bits
    whatever batch it is decoded in, which batched products and softmax do
    not (``tools/batch_invariance.py``).

Cache layout per layer: {"k": (B, S, Hkv, D), "v": (B, S, Hkv, D), "pos": (B,)}.
The decode step writes the new key and value into the cache IN PLACE (the
reference's batcher donates the cache, so no caller keeps the old one) and
advances ``pos`` in place too, returning the same dict.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops

from .layers import ParamStore, dense, rmsnorm, rope

__all__ = ["init_gqa", "init_gqa_cache", "gqa_attention"]


def init_gqa(store: ParamStore, name: str, cfg) -> None:
    sub = store.sub(name)
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    sub.param("wq", (d, h * hd))
    sub.param("wk", (d, kv * hd))
    sub.param("wv", (d, kv * hd))
    sub.param("wo", (h * hd, d))
    if cfg.qkv_bias:
        sub.param("bq", (h * hd,), init="zeros")
        sub.param("bk", (kv * hd,), init="zeros")
        sub.param("bv", (kv * hd,), init="zeros")
    if cfg.qk_norm:
        sub.param("q_norm", (hd,), init="ones")
        sub.param("k_norm", (hd,), init="ones")


def init_gqa_cache(cfg, batch: int, seq_len: int, dtype, device) -> Dict[str, Any]:
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, seq_len, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, seq_len, kv, hd), dtype=dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _project_qkv(x, p, cfg, positions):
    """-> q (B,H,S,hd), k and v (B,KV,S,hd); q and k roped."""
    b = x.shape[0]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = dense(x, p["wq"], p.get("bq")).reshape(b, -1, h, hd)
    k = dense(x, p["wk"], p.get("bk")).reshape(b, -1, kv, hd)
    v = dense(x, p["wv"], p.get("bv")).reshape(b, -1, kv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    q = rope(q, positions, theta=cfg.rope_theta, fraction=cfg.rope_fraction)
    k = rope(k, positions, theta=cfg.rope_theta, fraction=cfg.rope_fraction)
    return q, k, v


def gqa_attention(
    x: torch.Tensor,
    p: Dict[str, Any],
    cfg,
    *,
    positions: torch.Tensor,
    cache: Optional[Dict[str, Any]] = None,
    causal: bool = True,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Returns (out (B,S,d), updated cache). With ``cache``: one-token decode
    (S == 1); without: full-sequence self attention."""
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    q, k, v = _project_qkv(x, p, cfg, positions)

    if cache is None:
        out = ops.flash_attention(
            q.contiguous(),
            k.contiguous(),
            v.contiguous(),
            causal=causal,
            window=window,
            impl=cfg.attn_impl,
        )
        out = out.transpose(1, 2).reshape(b, s, h * hd)
        return dense(out, p["wo"]), None

    # ---- cached decode: S == 1, per-sequence insert at cache["pos"] ----------
    pos = cache["pos"]  # (B,): slots may be at different steps
    k_cache, v_cache = cache["k"], cache["v"]
    sc = k_cache.shape[1]
    ring = bool(window) and sc == window
    slot = (torch.remainder(pos, window) if ring else torch.clamp(pos, max=sc - 1)).long()
    bidx = torch.arange(b, device=x.device)
    k_cache[bidx, slot] = k[:, :, 0].to(k_cache.dtype)
    v_cache[bidx, slot] = v[:, :, 0].to(v_cache.dtype)
    out = ops.decode_attention(
        q[:, :, 0].contiguous(), k_cache, v_cache, pos, window=window, impl=cfg.attn_impl
    )  # (B, H, hd)
    out = out.reshape(b, s, h * hd)
    pos.add_(1)
    return dense(out, p["wo"]), cache
