"""Griffin / RecurrentGemma recurrent block: conv1d + RG-LRU with gating.

Counterpart of ``repro.models.rglru``, with the same names, layouts and
arithmetic:

    x -> [W_in gate branch -> GeLU] * [W_in rec branch -> conv1d(w=4) -> RG-LRU]
      -> W_out
    r_t = sigmoid(W_a xi + b_a);  i_t = sigmoid(W_x xi + b_x)   (float32)
    a_t = exp(-c * softplus(Lambda) * r_t),  c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * xi_t)       (``ops.rglru``)

Per-layer decode state: ``{"h": (B, lru_width) float32, "conv": (B, w-1,
lru_width)}``. Prefill and decode (T = 1) both go through ``ops.rglru``,
the Hopper kernel on the card; in training its gradient is the RG-LRU
backward kernel's (``ops.rglru`` through ``RGLRUFunction``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

from .layers import ParamStore, dense

__all__ = ["init_recurrent_block", "init_rglru_state", "recurrent_block"]

_C = 8.0  # Griffin's fixed temperature


def init_recurrent_block(store: ParamStore, name: str, cfg) -> None:
    sub = store.sub(name)
    d, w = cfg.d_model, cfg.lru_width
    sub.param("w_in_rec", (d, w))
    sub.param("w_in_gate", (d, w))
    sub.param("conv_w", (cfg.conv1d_width, w), scale=0.3)
    sub.param("conv_b", (w,), init="zeros")
    sub.param("lambda_", (w,), init="normal", scale=1.0)
    sub.param("w_a", (w, w))
    sub.param("b_a", (w,), init="zeros")
    sub.param("w_x", (w, w))
    sub.param("b_x", (w,), init="zeros")
    sub.param("w_out", (w, d))


def init_rglru_state(cfg, batch: int, dtype, device) -> Dict[str, Any]:
    w = cfg.lru_width
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv1d_width - 1, w), dtype=dtype, device=device),
    }


def _causal_conv1d(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, tail: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: (B,T,W); weight: (K,W). Returns (y, new tail (B,K-1,W))."""
    b, t, w = x.shape
    k = weight.shape[0]
    if tail is None:
        tail = x.new_zeros((b, k - 1, w))
    xp = torch.cat([tail.to(x.dtype), x], dim=1)  # (B, T+K-1, W)
    y = torch.zeros((b, t, w), dtype=torch.float32, device=x.device)
    if torch.is_grad_enabled() and any(z.requires_grad for z in (x, weight, bias, tail)):
        # out of place for autograd, the same float32 ops in the same order: the same bits
        for i in range(k):
            y = y + xp[:, i : i + t, :] * weight[i].float()
        y = (y + bias.float()).to(x.dtype)
    else:
        tap = torch.empty_like(y)
        for i in range(k):  # K is tiny (4): unrolled taps, in float32, one buffer for all
            y.add_(torch.mul(xp[:, i : i + t, :], weight[i].float(), out=tap))
        y = y.add_(bias.float()).to(x.dtype)
    # the tail as a copy: a view would keep all of xp alive in a prefill cache
    return y, xp[:, t:, :].clone()


def recurrent_block(
    x: torch.Tensor, p: Dict[str, Any], cfg, *, state: Optional[Dict[str, Any]] = None
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """x (B,T,d) -> (out (B,T,d), new state or None). ``state`` is not modified."""
    gate = F.gelu(dense(x, p["w_in_gate"]), approximate="tanh")
    xi = dense(x, p["w_in_rec"])
    tail = state["conv"] if state is not None else None
    xi, new_tail = _causal_conv1d(xi, p["conv_w"], p["conv_b"], tail)

    r = torch.sigmoid(dense(xi, p["w_a"], p["b_a"]).float())
    i = torch.sigmoid(dense(xi, p["w_x"], p["b_x"]).float())
    log_a_base = -_C * F.softplus(p["lambda_"].float())  # (W,)
    a = torch.exp(log_a_base * r)  # (B,T,W) in (0, 1)
    gated_in = (i * xi.float()).to(x.dtype)

    h0 = state["h"] if state is not None else None
    h, h_last = ops.rglru(gated_in, a, initial_state=h0, impl=cfg.attn_impl)
    out = dense(h * gate, p["w_out"])
    new_state = None
    if state is not None:
        new_state = {"h": h_last, "conv": new_tail}
    return out, new_state
