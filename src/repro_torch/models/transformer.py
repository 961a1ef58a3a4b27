"""Transformer assembly: layer pattern, segments, the stack's train, prefill and decode.

Counterpart of ``repro.models.transformer``. The layer stack is split into
the reference's SEGMENTS, (unit kinds, repeats), with params and caches
stacked along axis 0 of each segment, so the JAX param tree loads as it is.
Where the reference runs a segment unrolled (repeats <= 4) or as one
``lax.scan`` (the 8-layer demo), the port indexes the stacked params per
repeat in a Python loop: both layouts run the same way.

This port runs five kinds, in the modes ``prefill`` (build the cache),
``decode`` (one token against the cache, updated in place) and ``train``
(the whole sequence, no cache, under autograd;
``cfg.remat`` "full" recomputes each repeat of a segment unit in the
backward through ``torch.utils.checkpoint``, as the reference's
``jax.checkpoint`` around its unit body; "dots", which keeps the matmul
outputs, raises and names its ROADMAP item):

  dense : GQA self-attention + GLU MLP
  rec   : Griffin recurrent block (conv1d + RG-LRU) + GLU MLP
  attn  : dense inside a hybrid pattern; its attention is local (``cfg.window``)
          and its cache a ring of ``min(window, seq_len)`` slots
  rwkv  : RWKV6 time mix (WKV6) + channel mix; its cache is the O(1) state
          ``wkv`` (B, H, K, V) float32, ``tm_prev`` and ``cm_prev`` (B, d)
  moe   : dense with a Mixture-of-Experts block (``models/moe.py``) in place
          of the MLP

Every layer returns (h, cache, aux): aux is the MoE router's load-balance loss
(a float32 scalar; 0.0 for the other kinds), which ``run_stack`` sums over the
layers as the reference does. The encoder-decoder kinds raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils import checkpoint as _ckpt

from .attention import _project_qkv, gqa_attention, init_gqa, init_gqa_cache
from .layers import ParamStore, apply_norm, glu_mlp, init_glu_mlp, norm_param
from .moe import init_moe, moe_block
from .rglru import init_recurrent_block, init_rglru_state, recurrent_block
from .rwkv import init_rwkv_layer, init_rwkv_state, rwkv_channel_mix, rwkv_time_mix

__all__ = [
    "layer_pattern",
    "derive_segments",
    "init_layer",
    "init_layer_cache",
    "apply_layer",
    "init_stack",
    "init_stack_cache",
    "run_stack",
]

_NOT_PORTED = {
    "enc": "ROADMAP Queue 1, encoder-decoder and VLM",
    "xattn": "ROADMAP Queue 1, encoder-decoder and VLM",
}
_MODES = ("train", "prefill", "decode")


def _require_ported(cfg, kind: str) -> None:
    if kind in _NOT_PORTED:
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet: {_NOT_PORTED[kind]}")
    if kind not in ("dense", "rec", "attn", "rwkv", "moe"):
        raise ValueError(f"unknown layer kind {kind!r}")
    if cfg.mla and kind in ("dense", "attn", "moe"):
        raise NotImplementedError("MLA attention is not ported yet: ROADMAP Queue 1, MLA + MTP")


# --------------------------------------------------------------------------
# pattern -> segments
# --------------------------------------------------------------------------


def layer_pattern(cfg) -> Tuple[str, ...]:
    if cfg.block_pattern:
        return tuple(cfg.block_pattern)
    if cfg.family == "ssm":
        return ("rwkv",) * cfg.num_layers
    if cfg.num_experts:
        return ("dense",) * cfg.first_k_dense + ("moe",) * (cfg.num_layers - cfg.first_k_dense)
    if cfg.is_encdec:
        return ("xattn",) * cfg.num_layers  # decoder layers cross-attend
    return ("dense",) * cfg.num_layers


def derive_segments(pattern: Sequence[str], max_unit: int = 4) -> List[Tuple[Tuple[str, ...], int]]:
    """Greedy tiling: [(unit_kinds, repeats), ...] covering the pattern."""
    segments: List[Tuple[Tuple[str, ...], int]] = []
    i = 0
    n = len(pattern)
    while i < n:
        best: Tuple[int, int] = (1, 1)  # (unit_len, repeats)
        best_score = 0
        for ul in range(1, min(max_unit, n - i) + 1):
            unit = tuple(pattern[i : i + ul])
            r = 1
            while tuple(pattern[i + r * ul : i + (r + 1) * ul]) == unit:
                r += 1
            # only true repetition wins coverage: a long non-repeating unit
            # must not swallow a repeatable prefix (e.g. d,d,d,m vs (d)x3)
            score = r * ul if r >= 2 else 1
            if score > best_score or (score == best_score and ul < best[0]):
                best, best_score = (ul, r), score
        ul, r = best
        segments.append((tuple(pattern[i : i + ul]), r))
        i += ul * r
    return segments


# --------------------------------------------------------------------------
# single layer
# --------------------------------------------------------------------------


def _window(cfg, kind: str) -> Optional[int]:
    """The local-attention window of a layer of ``kind``, or None (global)."""
    return cfg.window if (cfg.window and kind == "attn") else None


def init_layer(store: ParamStore, cfg, kind: str) -> None:
    _require_ported(cfg, kind)
    if kind == "rwkv":  # the reference's order: both norms, then the block
        norm_param(store, "ln1", cfg.d_model, cfg.norm)
        norm_param(store, "ln2", cfg.d_model, cfg.norm)
        init_rwkv_layer(store, "rwkv", cfg)
        return
    norm_param(store, "ln1", cfg.d_model, cfg.norm)
    if kind == "rec":
        init_recurrent_block(store, "rec", cfg)
    else:
        init_gqa(store, "attn", cfg)
    norm_param(store, "ln2", cfg.d_model, cfg.norm)
    if kind == "moe":
        init_moe(store, "moe", cfg)
    else:
        init_glu_mlp(store, "mlp", cfg.d_model, cfg.d_ff, cfg.glu)


def init_layer_cache(cfg, kind: str, batch: int, seq_len: int, dtype, device) -> Dict[str, Any]:
    _require_ported(cfg, kind)
    if kind == "rwkv":
        return init_rwkv_state(cfg, batch, dtype, device)
    if kind == "rec":
        return init_rglru_state(cfg, batch, dtype, device)
    window = _window(cfg, kind)
    size = min(window, seq_len) if window else seq_len
    return init_gqa_cache(cfg, batch, size, dtype, device)


def _prefill_cache_from_full(h_in, lp, cfg, kind, positions, seq_len):
    """Recompute k/v once more to build the cache, as the reference does.

    A windowed layer longer than its window keeps the last ``window`` keys
    in ring order: slot i holds the key of position p with p % window == i.
    """
    b = h_in.shape[0]
    pos_vec = torch.full((b,), seq_len, dtype=torch.int32, device=h_in.device)
    _, k, v = _project_qkv(h_in, lp["attn"], cfg, positions)
    k = k.transpose(1, 2)  # (B, S, KV, hd)
    v = v.transpose(1, 2)
    window = _window(cfg, kind)
    if window and seq_len > window:
        k = torch.roll(k[:, -window:], seq_len % window, dims=1)
        v = torch.roll(v[:, -window:], seq_len % window, dims=1)
    return {"k": k.contiguous(), "v": v.contiguous(), "pos": pos_vec}


def apply_layer(
    h: torch.Tensor,
    lp: Dict[str, Any],
    cfg,
    kind: str,
    *,
    positions: torch.Tensor,
    mode: str,
    cache: Optional[Dict[str, Any]] = None,
) -> Tuple[torch.Tensor, Dict[str, Any], Any]:
    """One layer. Returns (h, cache, aux): the new cache in prefill, ``cache``
    itself (updated in place) in decode, None in train; the MoE aux loss, 0.0
    for a layer without experts."""
    _require_ported(cfg, kind)
    if mode not in _MODES:
        raise ValueError(f"mode {mode!r}: this port runs {', '.join(_MODES)}")
    if kind == "rwkv":
        return _apply_rwkv(h, lp, cfg, mode=mode, cache=cache)
    x1 = apply_norm(h, lp["ln1"], cfg.norm, cfg.norm_eps)
    if kind == "rec":
        if mode == "prefill":
            cache = init_rglru_state(cfg, h.shape[0], h.dtype, h.device)
        rec_out, state = recurrent_block(x1, lp["rec"], cfg, state=cache)
        h = h + rec_out
        if mode == "train":
            new_cache = None
        elif mode == "prefill":
            new_cache = state
        else:  # decode: write the new state into the cache in place
            cache["h"].copy_(state["h"])
            cache["conv"].copy_(state["conv"])
            new_cache = cache
    else:
        attn_out, new_cache = gqa_attention(
            x1,
            lp["attn"],
            cfg,
            positions=positions,
            cache=cache if mode == "decode" else None,
            window=_window(cfg, kind),
        )
        h = h + attn_out
        if mode == "prefill":
            new_cache = _prefill_cache_from_full(x1, lp, cfg, kind, positions, h.shape[1])
        elif mode == "train":
            new_cache = None
    x2 = apply_norm(h, lp["ln2"], cfg.norm, cfg.norm_eps)
    aux = 0.0
    if kind == "moe":
        ffn_out, aux = moe_block(x2, lp["moe"], cfg, with_aux=mode == "train")
    else:
        ffn_out = glu_mlp(x2, lp["mlp"], cfg.act, cfg.glu)
    return h + ffn_out, new_cache, aux


def _apply_rwkv(h, lp, cfg, *, mode, cache):
    """Time mix then channel mix, each behind its LayerNorm. Train and prefill
    start from the zero state, as the reference does; train keeps no cache,
    and decode writes the new state into ``cache`` in place."""
    if mode == "prefill":
        cache = init_rwkv_state(cfg, h.shape[0], h.dtype, h.device)
    x1 = apply_norm(h, lp["ln1"], cfg.norm, cfg.norm_eps)
    tm_out, state = rwkv_time_mix(x1, lp["rwkv"], cfg, state=cache)
    h = h + tm_out
    x2 = apply_norm(h, lp["ln2"], cfg.norm, cfg.norm_eps)
    cm_out, state = rwkv_channel_mix(x2, lp["rwkv"], cfg, state=state)
    h = h + cm_out
    if mode == "train":
        return h, None, 0.0
    if mode == "prefill":
        return h, state, 0.0  # tm_prev = x1[:, -1], cm_prev = x2[:, -1]
    for key in ("wkv", "tm_prev", "cm_prev"):
        cache[key].copy_(state[key])
    return h, cache, 0.0


# --------------------------------------------------------------------------
# stacked segments
# --------------------------------------------------------------------------


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(trees: Sequence[Any]):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(list(trees))


def init_stack(
    store: ParamStore, cfg, pattern: Sequence[str], prefix: str = "seg"
) -> List[Tuple[Tuple[str, ...], int]]:
    """Draw all layers, stacked per segment-unit position. Returns segments."""
    segments = derive_segments(pattern)
    for si, (unit, repeats) in enumerate(segments):
        seg = store.sub(f"{prefix}{si}")
        for uj, kind in enumerate(unit):
            copies = []
            for _ in range(repeats):
                tmp = ParamStore(store.generator, store.dtype, store.device)
                init_layer(tmp, cfg, kind)
                copies.append(tmp.params)
            seg.params[f"u{uj}"] = _stack(copies)
    return segments


def init_stack_cache(
    cfg, segments, batch: int, seq_len: int, dtype, device, prefix: str = "seg"
) -> Dict[str, Any]:
    cache: Dict[str, Any] = {}
    for si, (unit, repeats) in enumerate(segments):
        cache[f"{prefix}{si}"] = {
            f"u{uj}": _stack([init_layer_cache(cfg, kind, batch, seq_len, dtype, device)] * repeats)
            for uj, kind in enumerate(unit)
        }
    return cache


def _train_unit(h, unit, unit_params, cfg, positions):
    """One repeat of a segment unit in train mode, checkpointed as ``cfg.remat`` says."""

    def body(x):
        aux = 0.0
        for uj, kind in enumerate(unit):
            x, _, a = apply_layer(
                x, unit_params[f"u{uj}"], cfg, kind, positions=positions, mode="train"
            )
            aux = aux + a
        return x, aux

    if cfg.remat == "none":
        return body(h)
    if cfg.remat == "full":
        return _ckpt.checkpoint(body, h, use_reentrant=False)
    if cfg.remat == "dots":
        raise NotImplementedError(
            'remat="dots" (keep the matmul outputs) is not ported: ROADMAP Queue 1 item 13'
        )
    raise ValueError(f"remat {cfg.remat!r}: expected none, full or dots")


def run_stack(
    h: torch.Tensor,
    params: Dict[str, Any],
    cfg,
    segments,
    *,
    positions: torch.Tensor,
    mode: str,
    cache: Optional[Dict[str, Any]] = None,
    prefix: str = "seg",
) -> Tuple[torch.Tensor, Dict[str, Any], Any]:
    """Run all segments in order. Returns (h, cache, aux): a fresh stacked cache in
    prefill, the given ``cache`` (updated in place) in decode, None in train; the
    layers' MoE aux losses summed (0.0 without MoE layers outside train, a float32
    scalar tensor in train)."""
    if mode == "decode" and cache is None:
        raise ValueError("decode needs a cache")
    new_cache: Dict[str, Any] = {} if mode == "prefill" else cache
    total_aux = 0.0
    for si, (unit, repeats) in enumerate(segments):
        seg_params = params[f"{prefix}{si}"]
        outs: Dict[str, list] = {f"u{uj}": [] for uj in range(len(unit))}
        for r in range(repeats):
            if mode == "train":
                unit_params = {key: _index(p, r) for key, p in seg_params.items()}
                h, aux = _train_unit(h, unit, unit_params, cfg, positions)
                total_aux = total_aux + aux
                continue
            for uj, kind in enumerate(unit):
                key = f"u{uj}"
                layer_cache = None if mode == "prefill" else _index(cache[f"{prefix}{si}"][key], r)
                h, c_new, aux = apply_layer(
                    h,
                    _index(seg_params[key], r),
                    cfg,
                    kind,
                    positions=positions,
                    mode=mode,
                    cache=layer_cache,
                )
                total_aux = total_aux + aux
                if mode == "prefill":
                    outs[key].append(c_new)
        if mode == "prefill":
            new_cache[f"{prefix}{si}"] = {key: _stack(cs) for key, cs in outs.items()}
    return h, new_cache, total_aux
