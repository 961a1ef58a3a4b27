"""AdamW, global-norm clipping and LR schedules: the reference's own, not ``torch.optim``.

Counterpart of ``repro.optim.adamw``, the same arithmetic in the same order
on the same state layout ``{"m": tree, "v": tree, "step": int32}``, so a
state carries over between the two packages
(``repro_torch.params.from_numpy_opt_state``). Trees are nested dicts of
tensors; their leaves are walked in the reference's order (``jax.tree``
flattens dicts by sorted key), so the global norm sums its leaves in the
same order. Every function but :func:`adamw_update_` is out of place: the
inputs are left as they are, so a step can be run again from the same state.
:func:`adamw_update_` is the in-place twin (the reference's donated buffers):
it runs the same per-element operations in the same order, leaf by leaf, and
writes params, m and v into their own buffers, so both give the same bits.
``state_dtype="bfloat16"`` keeps m and v in bfloat16 (a plain cast, as the
reference does).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Tuple

import torch

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "adamw_update_",
    "global_norm",
    "clip_by_global_norm",
    "cosine_schedule",
    "linear_warmup_cosine",
    "tree_leaves",
    "tree_map",
]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"  # or "bfloat16" for the 671B memory mode
    schedule: str = "cosine"  # cosine | constant
    warmup_steps: int = 100
    total_steps: int = 10_000


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of a nested dict in ``jax.tree.leaves`` order (keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``, which share its keys."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest)) for key in tree}
    return fn(tree, *rest)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum, leaf by leaf in the reference's order, of each leaf's sum of squares."""
    total = None
    for x in tree_leaves(tree):
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def _clip(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (x.float() * scale).to(x.dtype)


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda x: _clip(x, scale), tree), norm


def cosine_schedule(step, base_lr: float, warmup: int, total: int) -> torch.Tensor:
    step = torch.as_tensor(step).float()
    warm = torch.clamp((step + 1) / max(warmup, 1), max=1.0)
    progress = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    return base_lr * warm * 0.5 * (1.0 + torch.cos(math.pi * progress))


def linear_warmup_cosine(cfg: AdamWConfig) -> Callable[[Any], torch.Tensor]:
    if cfg.schedule == "constant":
        return lambda step: torch.tensor(
            cfg.lr, dtype=torch.float32, device=torch.as_tensor(step).device
        )
    return lambda step: cosine_schedule(step, cfg.lr, cfg.warmup_steps, cfg.total_steps)


def adamw_init(params, cfg: AdamWConfig) -> Dict[str, Any]:
    dt = torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32
    device = tree_leaves(params)[0].device
    return {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device), params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def _schedule(step: torch.Tensor, cfg: AdamWConfig):
    """(lr, bc1, bc2) of the step about to be taken."""
    lr = linear_warmup_cosine(cfg)(step)
    t = (step + 1).float()
    return lr, 1.0 - torch.pow(cfg.b1, t), 1.0 - torch.pow(cfg.b2, t)


def _leaf_update(p, g, m, v, lr, bc1, bc2, cfg: AdamWConfig):
    """One leaf's (p, m, v) after the step, out of place; ``g`` already clipped."""
    b1, b2 = cfg.b1, cfg.b2
    gf = g.float()
    m_new = b1 * m.float() + (1 - b1) * gf
    v_new = b2 * v.float() + (1 - b2) * gf * gf
    mhat = m_new / bc1
    vhat = v_new / bc2
    delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
    p_new = p.float() - lr * delta
    return p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)


# Elements of a leaf clipped and updated at once. The update is elementwise, so a leaf taken
# in slices gets the same bits, and a step holds the float32 temporaries of one slice (about
# ten copies of it) instead of those of its largest leaf: 1.05B elements in recurrentgemma-9b's
# embedding, ~42 GB of temporaries beside two copies of params, m and v.
_SLICE = 1 << 26


def _update_into(p, g, m, v, scale, lr, bc1, bc2, cfg: AdamWConfig, dst) -> None:
    """Clip ``g`` by ``scale`` and write one leaf's (p, m, v) after the step into ``dst``
    (three tensors shaped and typed as p, m and v; the leaf's own buffers for the in-place
    step), slice by slice."""
    src = [x.reshape(-1) for x in (p, g, m, v)]
    out = [x.view(-1) for x in dst]
    n = src[0].numel()
    for start in range(0, n, _SLICE):
        ps, gs, ms, vs = (x[start : start + _SLICE] for x in src)
        new = _leaf_update(ps, _clip(gs, scale), ms, vs, lr, bc1, bc2, cfg)
        for o, x in zip(out, new, strict=True):
            o[start : start + _SLICE].copy_(x)


def adamw_update(
    params, grads, state, cfg: AdamWConfig
) -> Tuple[Any, Any, Dict[str, torch.Tensor]]:
    """Returns (new_params, new_state, metrics ``grad_norm`` and ``lr``); inputs untouched.

    The clipped gradient of a leaf is made where its update needs it, a slice at a time
    (:data:`_SLICE`): the step holds the inputs, their update and one slice's temporaries,
    not a clipped copy of every gradient. The bits are those of clipping the whole tree
    first (``clip_by_global_norm``) and updating each leaf at once."""
    step = state["step"]
    lr, bc1, bc2 = _schedule(step, cfg)
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)

    def upd(p, g, m, v):
        dst = (torch.empty_like(p), torch.empty_like(m), torch.empty_like(v))
        _update_into(p, g, m, v, scale, lr, bc1, bc2, cfg, dst)
        return dst

    out = tree_map(upd, params, grads, state["m"], state["v"])  # leaves: (p, m, v)
    new_params, new_m, new_v = (tree_map(lambda o, i=i: o[i], out) for i in range(3))
    new_state = {"m": new_m, "v": new_v, "step": step + 1}
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}


def adamw_update_(params, grads, state, cfg: AdamWConfig) -> Dict[str, torch.Tensor]:
    """:func:`adamw_update` in place: params, m, v and step are updated in their own
    buffers, which the caller must not need afterwards; returns the metrics.

    Each leaf is clipped and updated by the same operations as in
    :func:`adamw_update`, a slice at a time, and copied into its buffers before
    the next slice is touched, so the bits are the out-of-place update's and the
    step holds one slice's temporaries instead of a second copy of params, m
    and v. ``grads`` is left as it is.
    """
    step = state["step"]
    lr, bc1, bc2 = _schedule(step, cfg)
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    leaves = (tree_leaves(t) for t in (params, grads, state["m"], state["v"]))
    for p, g, m, v in zip(*leaves, strict=True):
        _update_into(p, g, m, v, scale, lr, bc1, bc2, cfg, (p, m, v))
    step.add_(1)
    return {"grad_norm": gnorm, "lr": lr}
