"""Shared neural-net substrate: norms, RoPE, GLU MLPs, dense, param drawing.

Counterpart of ``repro.models.layers``. Params are plain nested dicts of
tensors with the reference's names and layouts: a dense weight is
``(d_in, d_out)`` and is applied as ``x @ w`` (no transpose into
``nn.Linear``), so a JAX param tree loads as it is.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = [
    "ParamStore",
    "DTYPES",
    "rmsnorm",
    "layernorm",
    "apply_norm",
    "norm_param",
    "dense",
    "softcap",
    "rope",
    "init_glu_mlp",
    "glu_mlp",
]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


# --------------------------------------------------------------------------
# param drawing
# --------------------------------------------------------------------------


class ParamStore:
    """Draws a param tree with the reference's names, shapes and init laws.

    ``init="normal"``: truncated normal on [-2σ, 2σ], σ = 1/√fan_in (fan_in
    is the first dim); ``"embed"``: the same law with σ = 0.02; ``"zeros"``
    and ``"ones"`` as named. The numbers differ from ``jax.random``'s for
    the same seed; parity tests load the reference's params instead.
    On the ``meta`` device nothing is drawn (shapes only).
    """

    def __init__(
        self, generator: Optional[torch.Generator], dtype: torch.dtype, device: torch.device
    ):
        self.generator = generator
        self.dtype = dtype
        self.device = device
        self.params: Dict[str, Any] = {}

    def sub(self, name: str) -> "ParamStore":
        child = ParamStore(self.generator, self.dtype, self.device)
        self.params[name] = child.params
        return child

    def param(
        self, name: str, shape: Tuple[int, ...], init: str = "normal", scale: Optional[float] = None
    ) -> torch.Tensor:
        if self.device.type == "meta":
            val = torch.empty(shape, dtype=self.dtype, device=self.device)
        elif init == "zeros":
            val = torch.zeros(shape, dtype=self.dtype, device=self.device)
        elif init == "ones":
            val = torch.ones(shape, dtype=self.dtype, device=self.device)
        elif init in ("normal", "embed"):
            if init == "normal":
                fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
                std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
            else:
                std = scale if scale is not None else 0.02
            val = (self._truncated_normal(shape) * std).to(self.dtype)
        else:
            raise ValueError(init)
        self.params[name] = val
        return val

    def _truncated_normal(self, shape: Tuple[int, ...]) -> torch.Tensor:
        # inverse-CDF sampling on [-2, 2], as jax.random.truncated_normal does
        lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
        u = torch.rand(shape, generator=self.generator, dtype=torch.float32, device=self.device)
        x = math.sqrt(2) * torch.erfinv(lo + (hi - lo) * u)
        return x.clamp_(-2.0, 2.0)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------


def norm_param(store: ParamStore, name: str, dim: int, kind: str) -> None:
    sub = store.sub(name)
    sub.param("scale", (dim,), init="ones")
    if kind == "layernorm":
        sub.param("bias", (dim,), init="zeros")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """In float32, through ``F.rms_norm``. On an H100 its result for a 4096-wide row is
    the same alone and as one of four rows; a ``torch.mean`` reduction in its place
    differs there in the last bit of every element, and recurrentgemma-9b's logits for a
    request then drift apart between batch 1 and batch 4 (``tools/batch_invariance.py``)."""
    out = F.rms_norm(x.float(), (x.shape[-1],), scale.float(), eps)
    return out.to(x.dtype)


def layernorm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """In float32, with the population variance, through ``F.layer_norm``. On an
    H100 its result for a 4096-wide row is the same alone and as one of four rows;
    mean/var reductions in its place differ there in the last bit of some elements,
    and rwkv6-7b's logits for a request then drift apart between batch 1 and
    batch 4 (``tools/batch_invariance.py``)."""
    out = F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(), eps)
    return out.to(x.dtype)


def apply_norm(x: torch.Tensor, p: Dict[str, torch.Tensor], kind: str, eps: float = 1e-6):
    if kind == "rmsnorm":
        return rmsnorm(x, p["scale"], eps)
    return layernorm(x, p["scale"], p["bias"], eps)


# --------------------------------------------------------------------------
# dense / softcap
# --------------------------------------------------------------------------


def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w`` with ``w`` in the reference's ``(d_in, d_out)`` layout."""
    out = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        out = out + b.to(out.dtype)
    return out


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return logits
    return cap * torch.tanh(logits / cap)


# --------------------------------------------------------------------------
# rotary position embedding (half-split layout, partial fraction)
# --------------------------------------------------------------------------


def rope(
    x: torch.Tensor, positions: torch.Tensor, *, theta: float = 10_000.0, fraction: float = 1.0
) -> torch.Tensor:
    """x: (..., S, D) with positions (..., S) or (S,). Rotates the first
    ``fraction·D`` dims (StableLM partial rotary); the rest pass through."""
    d = x.shape[-1]
    rot = int(d * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    # float64, rounded once: float32 pow is off by an ulp in a few frequencies, and
    # differently on the CPU and the card, which position (up to the window and
    # beyond) multiplies into a visible difference of angle
    freqs = (theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)).float()
    ang = positions[..., None].float() * freqs  # (..., S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    # broadcast cos/sin over any head dims between batch and S
    while cos.dim() < x_rot.dim():
        cos, sin = cos.unsqueeze(-3), sin.unsqueeze(-3)
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
    return torch.cat([out, x_pass], dim=-1) if rot < d else out


# --------------------------------------------------------------------------
# (G)LU MLP
# --------------------------------------------------------------------------

_ACTS = {
    "silu": F.silu,
    "gelu": lambda t: F.gelu(t, approximate="tanh"),  # jax.nn.gelu's default
    "relu": F.relu,
}


def init_glu_mlp(store: ParamStore, name: str, d_model: int, d_ff: int, glu: bool = True) -> None:
    sub = store.sub(name)
    if glu:
        sub.param("w_gate", (d_model, d_ff))
    sub.param("w_up", (d_model, d_ff))
    sub.param("w_down", (d_ff, d_model))


def glu_mlp(
    x: torch.Tensor, p: Dict[str, torch.Tensor], act: str = "silu", glu: bool = True
) -> torch.Tensor:
    actf = _ACTS[act]
    up = dense(x, p["w_up"])
    h = up.mul_(actf(dense(x, p["w_gate"]))) if glu else actf(up)  # in place: one buffer fewer
    return dense(h, p["w_down"])
