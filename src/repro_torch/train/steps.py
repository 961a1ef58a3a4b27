"""Step functions: the units a trainer runs and a replay must reproduce bit for bit.

Counterpart of ``repro.train.steps``. ``make_train_step``: forward, loss,
backward, global-norm clip and AdamW, out of place (its inputs are left as
they were, so the same step can be run again from the same state and its
digest compared: the trainer's verify twin). ``make_donating_train_step``:
the same step updating params and AdamW state in their own buffers
(``adamw_update_``), the counterpart of the reference's step jitted with
``donate_argnums=(0, 1)``; it gives the out-of-place step's bits. On the card the step's
attention runs through the flash forward and backward kernels, whose sums
have a fixed order; run it under ``torch.use_deterministic_algorithms(True)``
with ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before the first cuBLAS handle
and two runs give equal bits. ``make_prefill_step`` / ``make_decode_step``:
the serving pair.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.models import Model
from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    adamw_update_,
    tree_leaves,
    tree_map,
)

__all__ = [
    "make_train_step",
    "make_donating_train_step",
    "make_prefill_step",
    "make_decode_step",
    "make_opt_init",
    "value_and_grad",
]


def _unflatten(tree, leaves):
    """A tree shaped as ``tree`` whose leaves, in ``tree_leaves`` order, come from ``leaves``."""
    if isinstance(tree, dict):
        return {key: _unflatten(tree[key], leaves) for key in sorted(tree)}
    return next(leaves)


def value_and_grad(
    loss_fn: Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]], params, batch
) -> Tuple[Tuple[torch.Tensor, Dict[str, torch.Tensor]], Any]:
    """((loss, metrics), grads) of ``loss_fn(params, batch)``, the counterpart of
    ``jax.value_and_grad(loss_fn, has_aux=True)``: grads has ``params``' tree, a leaf
    the loss does not reach gets zeros, and nothing returned holds the graph."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tree_leaves(live)
    loss, metrics = loss_fn(live, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads, strict=True)]
    metrics = {key: m.detach() for key, m in metrics.items()}
    return (loss.detach(), metrics), _unflatten(live, iter(grads))


def make_opt_init(model: Model, opt_cfg: AdamWConfig):
    def opt_init(params):
        return adamw_init(params, opt_cfg)

    return opt_init


def make_train_step(model: Model, opt_cfg: AdamWConfig):
    def train_step(params, opt_state, batch) -> Tuple[Any, Any, Dict[str, torch.Tensor]]:
        (_, metrics), grads = value_and_grad(model.loss_fn, params, batch)
        with torch.no_grad():
            new_params, new_state, opt_metrics = adamw_update(params, grads, opt_state, opt_cfg)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        return new_params, new_state, metrics

    return train_step


def make_donating_train_step(model: Model, opt_cfg: AdamWConfig):
    """``make_train_step`` in place: the returned params and state are the ones passed
    in, updated; the caller must not need their values from before the step."""

    def train_step(params, opt_state, batch) -> Tuple[Any, Any, Dict[str, torch.Tensor]]:
        (_, metrics), grads = value_and_grad(model.loss_fn, params, batch)
        with torch.no_grad():
            opt_metrics = adamw_update_(params, grads, opt_state, opt_cfg)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step


def make_prefill_step(model: Model):
    def prefill_step(params, batch):
        return model.prefill(params, batch)

    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, cache, batch):
        return model.decode_step(params, cache, batch)

    return decode_step
