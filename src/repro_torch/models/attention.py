"""Attention blocks, GQA and MLA: full-sequence (prefill) and cached decode.

Counterpart of ``repro.models.attention``. Two call modes:
  - full-sequence: ``ops.flash_attention`` (the Hopper kernel on the card);
  - cached decode: one token per sequence against a fixed-size cache with a
    per-sequence position, through ``ops.decode_attention``. The reference
    is plain jnp here; the port's kernel gives a sequence the same bits
    whatever batch it is decoded in, which batched products and softmax do
    not (``tools/batch_invariance.py``).

MLA (DeepSeek-V3's multi-head latent attention) prefills through the same
flash kernel, its latent expanded to per-head keys (``qk_nope + qk_rope``
columns) and values (``v_head_dim``), and decodes in the reference's absorbed
form in float32 plain torch (the reference has no kernel for it).

Cache layout per layer: GQA {"k": (B, S, Hkv, D), "v": (B, S, Hkv, D), "pos": (B,)};
MLA {"ckv": (B, S, kv_lora_rank), "krope": (B, S, qk_rope_head_dim), "pos": (B,)}.
Cross attention (an encoder-decoder's ``xattn`` layer) takes the encoder's keys and
values as given, (B, Hkv, Ssrc, D), which is the flash kernel's layout, and keeps no cache
of its own: ``models/transformer.py`` keeps them beside the self-attention's.
The decode step writes the new entries into the cache IN PLACE (the
reference's batcher donates the cache, so no caller keeps the old one) and
advances ``pos`` in place too, returning the same dict.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops

from .layers import ParamStore, apply_norm, dense, norm_param, rmsnorm, rope

__all__ = [
    "init_gqa",
    "init_gqa_cache",
    "gqa_attention",
    "init_mla",
    "init_mla_cache",
    "mla_attention",
]

_NEG_INF = -1e30


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
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Returns (out (B,S,d), updated cache). With ``cross_kv``: encoder-decoder cross
    attention, no cache; with ``cache``: one-token decode (S == 1); with neither:
    full-sequence self attention."""
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    if cross_kv is not None:
        # k, v (B, Hkv, Ssrc, hd), the layer's own projections of the encoder's output: no
        # norm on k and no rope on either side, every source row seen (Sq = 1 in decode)
        k, v = cross_kv
        q = dense(x, p["wq"], p.get("bq")).reshape(b, s, h, hd)
        if cfg.qk_norm:
            q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        out = ops.flash_attention(
            q.transpose(1, 2).contiguous(),
            k.contiguous(),
            v.contiguous(),
            causal=False,
            impl=cfg.attn_impl,
        )
        return dense(out.transpose(1, 2).reshape(b, s, h * hd), p["wo"]), None

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


# ==========================================================================
# MLA: DeepSeek-V3 multi-head latent attention
# ==========================================================================


def init_mla(store: ParamStore, name: str, cfg) -> None:
    sub = store.sub(name)
    d, h = cfg.d_model, cfg.num_heads
    qn, qr, vh = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    # query low-rank path
    sub.param("wq_a", (d, cfg.q_lora_rank))
    norm_param(sub, "q_norm", cfg.q_lora_rank, "rmsnorm")
    sub.param("wq_b", (cfg.q_lora_rank, h * (qn + qr)))
    # kv low-rank path: the compressed latent and the shared rope key
    sub.param("wkv_a", (d, cfg.kv_lora_rank + qr))
    norm_param(sub, "kv_norm", cfg.kv_lora_rank, "rmsnorm")
    sub.param("wkv_b", (cfg.kv_lora_rank, h * (qn + vh)))
    sub.param("wo", (h * vh, d))


def init_mla_cache(cfg, batch: int, seq_len: int, dtype, device) -> Dict[str, Any]:
    return {
        "ckv": torch.zeros((batch, seq_len, cfg.kv_lora_rank), dtype=dtype, device=device),
        "krope": torch.zeros((batch, seq_len, cfg.qk_rope_head_dim), dtype=dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _mla_q(x, p, cfg, positions):
    """-> q (B, H, S, qk_nope + qk_rope), its rope columns rotated."""
    b, s, _ = x.shape
    qn, qr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    cq = apply_norm(dense(x, p["wq_a"]), p["q_norm"], "rmsnorm", cfg.norm_eps)
    q = dense(cq, p["wq_b"]).reshape(b, s, cfg.num_heads, qn + qr).transpose(1, 2)
    q_rope = rope(q[..., qn:], positions, theta=cfg.rope_theta)
    return torch.cat([q[..., :qn], q_rope], dim=-1)


def _mla_latent(x, p, cfg, positions):
    """-> (ckv (B, S, kv_lora_rank) normed, krope (B, S, qk_rope) rotated): what the cache keeps."""
    r = cfg.kv_lora_rank
    kv_a = dense(x, p["wkv_a"])
    ckv = apply_norm(kv_a[..., :r], p["kv_norm"], "rmsnorm", cfg.norm_eps)
    krope = rope(kv_a[..., r:], positions, theta=cfg.rope_theta)
    return ckv, krope


def _mla_expand_kv(ckv, krope, p, cfg):
    """Latent (B, S, r) and the shared rope key (B, S, qr) -> per-head k (B, H, S, qn + qr)
    (the rope key broadcast to every head) and v (B, H, S, vh)."""
    b, s, _ = ckv.shape
    h, qn, qr, vh = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    kv = dense(ckv, p["wkv_b"]).reshape(b, s, h, qn + vh).transpose(1, 2)
    k_rope = krope[:, None].expand(b, h, s, qr)
    return torch.cat([kv[..., :qn], k_rope], dim=-1), kv[..., qn:]


def mla_attention(
    x: torch.Tensor,
    p: Dict[str, Any],
    cfg,
    *,
    positions: torch.Tensor,
    cache: Optional[Dict[str, Any]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Returns (out (B,S,d), updated cache). Without ``cache``: causal self attention over
    the whole sequence through ``ops.flash_attention`` at key head dim qk_nope + qk_rope and
    value head dim v_head_dim, scaled by (qk_nope + qk_rope)^-0.5. With ``cache``: one-token
    decode in the absorbed form, in float32 (:func:`_mla_absorbed`)."""
    b, s, _ = x.shape
    h, qn, qr, vh = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    scale = (qn + qr) ** -0.5
    q = _mla_q(x, p, cfg, positions)
    ckv, krope = _mla_latent(x, p, cfg, positions)

    if cache is None:
        k, v = _mla_expand_kv(ckv, krope, p, cfg)
        out = ops.flash_attention(
            q.contiguous(),
            k.contiguous(),
            v.contiguous(),
            causal=True,
            scale=scale,
            impl=cfg.attn_impl,
        )
        out = out.transpose(1, 2).reshape(b, s, h * vh)
        return dense(out, p["wo"]), None

    # ---- cached decode: S == 1, per-sequence insert at cache["pos"] ----------
    pos = cache["pos"]  # (B,): slots may be at different steps
    ckv_c, krope_c = cache["ckv"], cache["krope"]
    slot = torch.clamp(pos, max=ckv_c.shape[1] - 1).long()
    bidx = torch.arange(b, device=x.device)
    ckv_c[bidx, slot] = ckv[:, 0].to(ckv_c.dtype)
    krope_c[bidx, slot] = krope[:, 0].to(krope_c.dtype)
    out = _mla_absorbed(q, ckv_c, krope_c, pos, p["wkv_b"], cfg, scale).to(x.dtype)
    out = out.transpose(1, 2).reshape(b, s, h * vh)
    pos.add_(1)
    return dense(out, p["wo"]), cache


def _mla_absorbed(q, ckv_c, krope_c, pos, wkv_b, cfg, scale: float) -> torch.Tensor:
    """One decode step in the ABSORBED form, in float32, as the reference computes it: stay
    in the latent space, never expand the cache to per-head keys and values.

        logits = ((q_nope . W_uk) . ckv + q_rope . krope) * scale, masked to slots <= pos
        out    = (softmax(logits) . ckv) . W_uv

    q (B, H, 1, qk_nope + qk_rope); caches (B, Sc, r) and (B, Sc, qk_rope) holding this
    step's entries; ``wkv_b`` (r, H * (qk_nope + v_head_dim)) split into W_uk and W_uv.
    Returns (B, H, 1, v_head_dim) float32."""
    h, qn, vh = cfg.num_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    r, sc = cfg.kv_lora_rank, ckv_c.shape[1]
    w = wkv_b.reshape(r, h, qn + vh)
    w_uk, w_uv = w[..., :qn].float(), w[..., qn:].float()  # (r, H, qn), (r, H, vh)
    ckv_f = ckv_c.float()
    q_lat = torch.einsum("bhqn,rhn->bhqr", q[..., :qn].float(), w_uk)  # (B, H, 1, r)
    logits = torch.einsum("bhqr,bsr->bhqs", q_lat, ckv_f) + torch.einsum(
        "bhqe,bse->bhqs", q[..., qn:].float(), krope_c.float()
    )
    logits = logits * scale
    valid = torch.arange(sc, device=q.device)[None, :] <= pos[:, None]
    logits = logits.masked_fill(~valid[:, None, None, :], _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqr,rhv->bhqv", torch.einsum("bhqs,bsr->bhqr", probs, ckv_f), w_uv)
