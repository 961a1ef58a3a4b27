"""RWKV6 "Finch" blocks: data-dependent token shift + WKV6 + channel mix.

Counterpart of ``repro.models.rwkv``, with the same names, layouts and
arithmetic. Attention-free: the per-layer decode state is
``{"wkv": (B, H, K, V) float32, "tm_prev": (B, d), "cm_prev": (B, d)}``
(the time-mix and channel-mix token-shift inputs, in the compute dtype),
O(1) in the sequence length. Prefill and decode (T = 1) both go through
``ops.wkv6``, the Hopper kernel on the card.

Decay contract: the per-step log decay is
``-exp(clip(w0 + decay_b(tanh(decay_a(x_w))), -20, 1.3863))`` in float32,
then clamped to [-4, -1e-4] before the WKV op; the chunked kernel's float32
range rests on it (``ref.wkv6_chunked_ref``). The per-head group norm
(``ln_x``) uses the population variance and eps 64e-5 in float32, through
``F.layer_norm`` over each head, as ``layers.layernorm`` does (see there why).

The reference's ``shard_activation`` calls are left out: on one device they
are the identity.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

from .layers import ParamStore, dense

__all__ = ["init_rwkv_layer", "init_rwkv_state", "rwkv_time_mix", "rwkv_channel_mix"]

_LOGW_MIN, _LOGW_MAX = -4.0, -1e-4
_STREAMS = ("r", "k", "v", "w", "g")


def init_rwkv_layer(store: ParamStore, name: str, cfg) -> None:
    sub = store.sub(name)
    d = cfg.d_model
    hs = cfg.rwkv_head_size
    n_heads = d // hs
    dl, ml = cfg.rwkv_decay_lora, cfg.rwkv_mix_lora

    tm = sub.sub("time_mix")
    for s in _STREAMS:  # static token-shift mixing coefficients
        tm.param(f"mu_{s}", (d,), init="zeros")
    tm.param("mu_x", (d,), init="zeros")
    # data-dependent mixing LoRA (shifted x -> per-stream corrections)
    tm.param("mix_a", (d, ml * 5), scale=0.02)
    tm.param("mix_b", (ml * 5, d * 5), scale=0.02)
    for proj in ("wr", "wk", "wv", "wg", "wo"):
        tm.param(proj, (d, d))
    # data-dependent decay LoRA, static decay, bonus
    tm.param("w0", (d,), init="zeros")
    tm.param("decay_a", (d, dl), scale=0.02)
    tm.param("decay_b", (dl, d), scale=0.02)
    tm.param("u", (n_heads, hs), init="normal", scale=0.5)
    tm.sub("ln_x").param("scale", (d,), init="ones")

    cm = sub.sub("channel_mix")
    cm.param("mu_r", (d,), init="zeros")
    cm.param("mu_k", (d,), init="zeros")
    cm.param("wk", (d, cfg.d_ff))
    cm.param("wv", (cfg.d_ff, d))
    cm.param("wr", (d, d))


def init_rwkv_state(cfg, batch: int, dtype, device) -> Dict[str, Any]:
    d = cfg.d_model
    hs = cfg.rwkv_head_size
    return {
        "wkv": torch.zeros((batch, d // hs, hs, hs), dtype=torch.float32, device=device),
        "tm_prev": torch.zeros((batch, d), dtype=dtype, device=device),
        "cm_prev": torch.zeros((batch, d), dtype=dtype, device=device),
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """The x_{t-1} stream: zeros (or the carried state) at t = 0."""
    first = x.new_zeros((x.shape[0], 1, x.shape[2])) if prev is None else prev[:, None, :]
    return torch.cat([first.to(x.dtype), x[:, :-1, :]], dim=1)


def rwkv_time_mix(
    x: torch.Tensor, p: Dict[str, Any], cfg, *, state: Optional[Dict[str, Any]] = None
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """x (B,T,d) -> (out (B,T,d), new state or None). ``state`` is not modified."""
    b, t, d = x.shape
    hs = cfg.rwkv_head_size
    n_heads = d // hs
    tm = p["time_mix"]
    prev = state["tm_prev"] if state is not None else None
    dx = _token_shift(x, prev) - x

    # data-dependent mixing (Finch's DDLerp)
    base = x + dx * tm["mu_x"]
    lora = torch.tanh(dense(base, tm["mix_a"]))  # (B,T,5*ml)
    corr = dense(lora, tm["mix_b"]).reshape(b, t, 5, d)
    streams = {s: x + dx * (tm[f"mu_{s}"] + corr[:, :, i, :]) for i, s in enumerate(_STREAMS)}

    r = dense(streams["r"], tm["wr"]).reshape(b, t, n_heads, hs)
    k = dense(streams["k"], tm["wk"]).reshape(b, t, n_heads, hs)
    v = dense(streams["v"], tm["wv"]).reshape(b, t, n_heads, hs)
    g = dense(streams["g"], tm["wg"])
    logw = tm["w0"] + dense(torch.tanh(dense(streams["w"], tm["decay_a"])), tm["decay_b"])
    logw = -torch.exp(torch.clamp(logw.float(), -20.0, 1.3863))  # >= -e^1.3863 = -4
    logw = torch.clamp(logw, _LOGW_MIN, _LOGW_MAX)
    w = torch.exp(logw).reshape(b, t, n_heads, hs)

    # (B,H,T,.) views for the kernel, which takes strides: no copies
    s0 = state["wkv"] if state is not None else None
    out, s_new = ops.wkv6(
        r.transpose(1, 2),
        k.transpose(1, 2),
        v.transpose(1, 2),
        w.transpose(1, 2),
        tm["u"].to(r.dtype),
        initial_state=s0,
        impl=cfg.attn_impl,
    )

    # per-head group norm (ln_x): population variance, eps 64e-5, float32; then the gate
    outf = F.layer_norm(out.transpose(1, 2).float(), (hs,), eps=64e-5)  # (B,T,H,V)
    out = (outf.reshape(b, t, d) * tm["ln_x"]["scale"].float()).to(x.dtype)
    out = dense(out * F.silu(g), tm["wo"])
    new_state = None
    if state is not None:
        new_state = dict(state, wkv=s_new, tm_prev=x[:, -1, :])
    return out, new_state


def rwkv_channel_mix(
    x: torch.Tensor, p: Dict[str, Any], cfg, *, state: Optional[Dict[str, Any]] = None
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """x (B,T,d) -> (out (B,T,d), new state or None). ``state`` is not modified."""
    cm = p["channel_mix"]
    prev = state["cm_prev"] if state is not None else None
    dx = _token_shift(x, prev) - x
    xk = x + dx * cm["mu_k"]
    xr = x + dx * cm["mu_r"]
    hidden = torch.square(F.relu(dense(xk, cm["wk"])))
    out = torch.sigmoid(dense(xr, cm["wr"])) * dense(hidden, cm["wv"])
    new_state = None
    if state is not None:
        new_state = dict(state, cm_prev=x[:, -1, :])
    return out, new_state
