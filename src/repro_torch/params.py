"""The port's param tree: drawing it, loading the JAX package's, counting it.

The tree has the reference's names and layouts (``embed/table``,
``seg{i}/u{j}/attn/wq`` or ``seg{i}/u{j}/rwkv/time_mix/wr`` stacked on
axis 0, ``final_norm/scale``, ``unembed``; with ``cfg.mtp`` the ``mtp``
subtree of DeepSeek-V3's multi-token prediction: ``norm_h``, ``norm_e``,
``proj`` (2d, d) and one dense ``layer``, unstacked; an encoder-decoder's
``encoder`` subtree: ``frontend_proj`` (frontend_dim, d), its ``enc`` stack
``seg{i}`` and ``final_norm``; a VLM's ``frontend``: ``proj1`` (frontend_dim, d)
and ``proj2`` (d, d)), so a tree of numpy
arrays taken from ``repro``'s ``model.init`` loads with :func:`from_numpy_tree` as it is, without
renaming or transposing anything, and the reference's AdamW state (``m``,
``v``, ``step``) with :func:`from_numpy_opt_state`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import DTYPES, ParamStore, norm_param
from repro_torch.models.model import padded_vocab
from repro_torch.models.transformer import init_layer, init_stack, layer_pattern
from repro_torch.wire.bfloat16 import BFloat16Array

__all__ = ["init_params", "from_numpy_tree", "from_numpy_opt_state", "count_params"]


def _draw(cfg: ModelConfig, generator: Optional[torch.Generator], device: torch.device):
    vpad = padded_vocab(cfg)
    store = ParamStore(generator, DTYPES[cfg.param_dtype], device)
    store.sub("embed").param("table", (vpad, cfg.d_model), init="embed")
    init_stack(store, cfg, layer_pattern(cfg), prefix="seg")
    norm_param(store, "final_norm", cfg.d_model, cfg.norm)
    if not cfg.tie_embeddings:
        store.param("unembed", (cfg.d_model, vpad), scale=0.02)
    if cfg.is_encdec:
        enc = store.sub("encoder")
        enc.param("frontend_proj", (cfg.frontend_dim or cfg.d_model, cfg.d_model))
        init_stack(enc, cfg, ("enc",) * cfg.encoder_layers, prefix="seg")
        norm_param(enc, "final_norm", cfg.d_model, cfg.norm)
    if cfg.frontend == "vision_stub":
        fr = store.sub("frontend")
        fr.param("proj1", (cfg.frontend_dim, cfg.d_model))
        fr.param("proj2", (cfg.d_model, cfg.d_model))
    if cfg.mtp:  # drawn in the reference's order; only the MTP loss runs it
        mtp = store.sub("mtp")
        norm_param(mtp, "norm_h", cfg.d_model, cfg.norm)
        norm_param(mtp, "norm_e", cfg.d_model, cfg.norm)
        mtp.param("proj", (2 * cfg.d_model, cfg.d_model))
        init_layer(mtp.sub("layer"), cfg, "dense")
    return store.params


def init_params(
    cfg: ModelConfig, generator: Optional[torch.Generator] = None, device: DeviceLike = None
) -> Dict[str, Any]:
    """Draw the param tree on ``device`` (default ``cuda``; raises without one).

    Truncated normal on [-2σ, 2σ] with σ = 1/√fan_in, σ = 0.02 for the
    embedding and unembedding; norms start at one. Pass a seeded
    ``torch.Generator`` on the same device for a reproducible draw.
    """
    return _draw(cfg, generator, resolve_device(device))


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Number of parameters in ``cfg``'s tree (shapes only, nothing drawn).

    With ``active_only``, the routed experts' leaves (every leaf under an
    ``experts`` key) count k/E of their size, those one token runs through, as the
    reference's ``count_params_analytic(cfg, active_only=True)`` counts them.
    """
    total = routed = 0

    def visit(tree, in_experts):
        nonlocal total, routed
        if isinstance(tree, Mapping):
            for key, v in tree.items():
                visit(v, in_experts or key == "experts")
        else:
            total += tree.numel()
            routed += tree.numel() if in_experts else 0

    visit(_draw(cfg, None, torch.device("meta")), False)
    if active_only and cfg.num_experts:
        total = total - routed + routed * cfg.num_experts_per_tok // cfg.num_experts
    return total


def _tensor(x: Any) -> torch.Tensor:
    if isinstance(x, BFloat16Array):  # the port's host form of bfloat16: its bits
        return torch.from_numpy(x.bits().copy()).view(torch.bfloat16)
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' (numpy has no bfloat16): move the bits
        bits = np.ascontiguousarray(arr).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True, order="C"))


def from_numpy_tree(tree: Mapping[str, Any], device: DeviceLike = None) -> Dict[str, Any]:
    """A nested dict of arrays (e.g. the JAX package's params through
    ``np.asarray``, or a tree ``repro_torch.train.host.to_host`` or the checkpoint
    store gave) as the port's tree on ``device`` (default ``cuda``). Names, shapes,
    layouts and dtypes are kept as they are; bfloat16, an ``ml_dtypes`` array or the
    port's ``BFloat16Array``, is moved by its bits."""
    dev = resolve_device(device)

    def walk(t):
        if isinstance(t, Mapping):
            return {k: walk(v) for k, v in t.items()}
        return _tensor(t).to(dev)

    return walk(tree)


def from_numpy_opt_state(state: Mapping[str, Any], device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's AdamW state ``{"m": tree, "v": tree, "step": int32 scalar}`` (arrays,
    e.g. through ``np.asarray``) as the port's (``repro_torch.optim.adamw_init``'s layout) on
    ``device``: m and v keep their dtype (float32, or bfloat16 moved by its bits, from
    either host form), step stays an int32 scalar."""
    missing = {"m", "v", "step"} - set(state)
    if missing:
        raise ValueError(f"from_numpy_opt_state: no {sorted(missing)} in the state")
    dev = resolve_device(device)
    step = np.asarray(state["step"])
    if step.shape != () or step.dtype != np.int32:
        raise ValueError(
            f"from_numpy_opt_state: step must be an int32 scalar, got {step.dtype}{step.shape}"
        )
    return {
        "m": from_numpy_tree(state["m"], dev),
        "v": from_numpy_tree(state["v"], dev),
        "step": _tensor(step).to(dev),
    }
