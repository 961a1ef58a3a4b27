"""Public model API: build(cfg, device) -> Model with prefill / decode_step / init_cache.

Counterpart of ``repro.models.model`` for decoder LMs. Batch conventions
(int tokens): prefill ``{"tokens": (B, S)}``, decode ``{"token": (B,)}`` plus
the cache. ``prefill`` returns (last-position logits, cache);
``decode_step`` consumes one token per sequence against the cache, which
it updates in place and returns. ``loss_fn``, MTP, encoder-decoder and VLM
inputs come with later slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device

from .layers import DTYPES, apply_norm, softcap
from .transformer import derive_segments, init_stack_cache, layer_pattern, run_stack

__all__ = ["Model", "build", "padded_vocab"]

_NEG_INF = -1e30


def padded_vocab(cfg: ModelConfig) -> int:
    """Vocab padded to a multiple of 512, as the reference's tables are."""
    return ((cfg.vocab_size + 511) // 512) * 512


@dataclass
class Model:
    cfg: ModelConfig
    device: torch.device
    prefill: Callable[..., Tuple[torch.Tensor, Dict]]
    decode_step: Callable[..., Tuple[torch.Tensor, Dict]]
    init_cache: Callable[..., Dict]
    segments: Any


def build(cfg: ModelConfig, device: DeviceLike = None) -> Model:
    """The model's functions for ``cfg`` on ``device`` (default ``cuda``; raises without one)."""
    if cfg.is_encdec or cfg.frontend != "none":
        raise NotImplementedError(
            "encoder-decoder and frontend inputs are not ported yet: "
            "ROADMAP Queue 1, encoder-decoder and VLM"
        )
    dev = resolve_device(device)
    segments = derive_segments(layer_pattern(cfg))
    cdtype = DTYPES[cfg.compute_dtype]
    vpad = padded_vocab(cfg)

    def embed_tokens(params, tokens):
        return params["embed"]["table"][tokens].to(cdtype)

    def unembed(params, h):
        h = apply_norm(h, params["final_norm"], cfg.norm, cfg.norm_eps)
        if cfg.tie_embeddings:
            logits = torch.matmul(h.float(), params["embed"]["table"].float().t())
        else:
            logits = torch.matmul(h.float(), params["unembed"].float())
        logits = softcap(logits, cfg.logit_softcap)
        if vpad != cfg.vocab_size:  # pad-vocab slots never win a softmax or argmax
            logits[..., cfg.vocab_size :] = _NEG_INF
        return logits

    def prefill(params, batch, pad_to: int = 0) -> Tuple[torch.Tensor, Dict]:
        tokens = batch["tokens"]
        h = embed_tokens(params, tokens)
        positions = torch.arange(h.shape[1], device=h.device)
        h, cache = run_stack(h, params, cfg, segments, positions=positions, mode="prefill")
        logits = unembed(params, h[:, -1:, :])[:, 0, : cfg.vocab_size]
        if pad_to:
            cache = _pad_cache(cache, pad_to)
        return logits, cache

    def init_cache(batch_size: int, seq_len: int) -> Dict:
        return init_stack_cache(cfg, segments, batch_size, seq_len, cdtype, dev)

    def decode_step(params, cache, batch) -> Tuple[torch.Tensor, Dict]:
        tok = batch["token"]  # (B,)
        h = embed_tokens(params, tok[:, None])  # (B, 1, d)
        positions = _cache_pos(cache, tok.shape[0])[:, None]  # (B, 1) for rope
        h, cache = run_stack(
            h, params, cfg, segments, positions=positions, mode="decode", cache=cache
        )
        logits = unembed(params, h[:, 0, :])[:, : cfg.vocab_size]
        return logits, cache

    return Model(
        cfg=cfg,
        device=dev,
        prefill=prefill,
        decode_step=decode_step,
        init_cache=init_cache,
        segments=segments,
    )


_PAD_AXIS = {"k": -3, "v": -3}


def _pad_cache(cache, pad_to: int):
    """Grow a prefill cache to ``pad_to`` slots (decode appends after S)."""

    def walk(tree, key):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if key not in _PAD_AXIS:
            return tree
        ax = _PAD_AXIS[key] % tree.dim()
        cur = tree.shape[ax]
        if cur >= pad_to:
            return tree
        shape = list(tree.shape)
        shape[ax] = pad_to
        out = tree.new_zeros(shape)
        out.narrow(ax, 0, cur).copy_(tree)
        return out

    return walk(cache, "")


def _cache_pos(cache, batch: int) -> torch.Tensor:
    """Per-sequence decode positions (B,): the max over every 'pos' leaf.

    Leaves are (L, B), stacked per segment; layers advance together, so
    the max across layers is exact."""
    poses = []

    def visit(tree, key):
        if isinstance(tree, dict):
            for k in sorted(tree):
                visit(tree[k], k)
        elif key == "pos":
            v = tree
            while v.dim() > 1:
                v = v.amax(dim=0)
            poses.append(v.expand(batch))

    visit(cache, "")
    out = poses[0]
    for p in poses[1:]:
        out = torch.maximum(out, p)
    return out
