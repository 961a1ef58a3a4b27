"""Public model API: build(cfg, device) -> Model with loss_fn / prefill / decode_step /
init_cache.

Counterpart of ``repro.models.model`` for decoder LMs. Batch conventions
(int tokens): train and prefill ``{"tokens": (B, S)}``, decode
``{"token": (B,)}`` plus the cache. ``loss_fn`` returns (loss, metrics): the
next-token cross-entropy in float32 over the padded vocab plus
``z_loss_coef``·mean(lse²) plus the MoE layers' load-balance loss (``aux_loss``),
differentiable by autograd (the attention's gradient through the flash backward
kernel on the card). ``prefill``
returns (last-position logits, cache); ``decode_step`` consumes one token
per sequence against the cache, which it updates in place and returns.
MTP, encoder-decoder and VLM inputs come with later slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device

from .layers import DTYPES, apply_norm, softcap
from .transformer import _window, derive_segments, init_stack_cache, layer_pattern, run_stack

__all__ = ["Model", "build", "padded_vocab", "unembed_logits"]

_NEG_INF = -1e30


def padded_vocab(cfg: ModelConfig) -> int:
    """Vocab padded to a multiple of 512, as the reference's tables are."""
    return ((cfg.vocab_size + 511) // 512) * 512


class _Bf16Unembed(torch.autograd.Function):
    """bf16 (N, d) x bf16 (d, vocab) -> float32 logits in one product, and its gradient.

    ``torch.mm(..., out_dtype=torch.float32)`` has no derivative in PyTorch. The backward
    takes the float32 logits' gradient to bfloat16 once for the tensor cores and returns
    dh and dw in bfloat16, the dtype of the operands, each from one product with float32
    sums; no float32 copy of the vocabulary matrix is made here either.
    """

    @staticmethod
    def forward(ctx, h2d, w):
        ctx.save_for_backward(h2d, w)
        return torch.mm(h2d, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad):
        h2d, w = ctx.saved_tensors
        g = grad.to(torch.bfloat16)
        dh = torch.mm(g, w.t()) if ctx.needs_input_grad[0] else None
        dw = torch.mm(h2d.t(), g) if ctx.needs_input_grad[1] else None
        return dh, dw


def unembed_logits(params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Final norm, then float32 logits over the padded vocab; pad slots at -1e30.

    On the card, bf16 ``h`` and a bf16 vocabulary matrix (``unembed``, or the tied
    ``embed/table`` transposed) go into one product with float32 accumulation and
    output, the reference's ``preferred_element_type=jnp.float32`` einsum: no float32
    copy of the (d, vocab) matrix is made (4.19 GB for recurrentgemma-9b); in training
    its gradient is :class:`_Bf16Unembed`'s. Elsewhere (float32 models, the CPU) both
    operands are taken in float32.
    """
    h = apply_norm(h, params["final_norm"], cfg.norm, cfg.norm_eps)
    w = params["embed"]["table"].t() if cfg.tie_embeddings else params["unembed"]
    if h.is_cuda and h.dtype == w.dtype == torch.bfloat16:
        h2d = h.reshape(-1, h.shape[-1])
        logits = _Bf16Unembed.apply(h2d, w).reshape(*h.shape[:-1], -1)
    else:
        logits = torch.matmul(h.float(), w.float())
    logits = softcap(logits, cfg.logit_softcap)
    vpad = padded_vocab(cfg)
    if vpad != cfg.vocab_size:  # pad-vocab slots never win a softmax or argmax
        logits[..., cfg.vocab_size :] = _NEG_INF
    return logits


def _ce_loss(logits: torch.Tensor, targets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean next-token cross-entropy, mean lse²) in float32. The gold logit is taken by
    ``torch.gather``, whose gradient on the card is deterministic (a scatter with no two
    writes to one place)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return torch.mean(lse - gold), torch.mean(torch.square(lse))


@dataclass
class Model:
    cfg: ModelConfig
    device: torch.device
    loss_fn: Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
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

    def embed_tokens(params, tokens):
        return params["embed"]["table"][tokens].to(cdtype)

    def unembed(params, h):
        return unembed_logits(params, h, cfg)

    def loss_fn(params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        if cfg.mtp:
            raise NotImplementedError("the MTP loss is not ported yet: ROADMAP Queue 1 item 9")
        tokens = batch["tokens"]
        h = embed_tokens(params, tokens)
        positions = torch.arange(h.shape[1], device=h.device)
        h, _, aux = run_stack(h, params, cfg, segments, positions=positions, mode="train")
        logits = unembed(params, h)  # (B, S, padded vocab) float32
        ce, z = _ce_loss(logits[:, :-1], tokens[:, 1:])
        # the MoE layers' load-balance losses, summed over the stack (zero without them)
        aux = torch.as_tensor(aux, dtype=torch.float32, device=h.device)
        loss = ce + cfg.z_loss_coef * z + aux
        return loss, {"ce": ce, "z_loss": z, "aux_loss": aux, "loss": loss}

    def prefill(params, batch, pad_to: int = 0) -> Tuple[torch.Tensor, Dict]:
        tokens = batch["tokens"]
        h = embed_tokens(params, tokens)
        positions = torch.arange(h.shape[1], device=h.device)
        h, cache, _ = run_stack(h, params, cfg, segments, positions=positions, mode="prefill")
        logits = unembed(params, h[:, -1:, :])[:, 0, : cfg.vocab_size]
        if pad_to:
            cache = _pad_cache(cache, pad_to, cfg, segments)
        return logits, cache

    def init_cache(batch_size: int, seq_len: int) -> Dict:
        return init_stack_cache(cfg, segments, batch_size, seq_len, cdtype, dev)

    def decode_step(params, cache, batch) -> Tuple[torch.Tensor, Dict]:
        tok = batch["token"]  # (B,)
        h = embed_tokens(params, tok[:, None])  # (B, 1, d)
        positions = _cache_pos(cache, tok.shape[0])[:, None]  # (B, 1) for rope
        h, cache, _ = run_stack(
            h, params, cfg, segments, positions=positions, mode="decode", cache=cache
        )
        logits = unembed(params, h[:, 0, :])[:, : cfg.vocab_size]
        return logits, cache

    return Model(
        cfg=cfg,
        device=dev,
        loss_fn=loss_fn,
        prefill=prefill,
        decode_step=decode_step,
        init_cache=init_cache,
        segments=segments,
    )


def _pad_cache(cache, pad_to: int, cfg, segments):
    """Grow a prefill cache to the decode cache's size (decode appends after S).

    A global layer's k/v grow to ``pad_to`` slots. A windowed layer's grow
    to ``min(window, pad_to)`` and never past the window, which is the size
    of the batcher's cache for that layer (``init_layer_cache``); a ring
    (a prompt longer than the window) is already that size and stays as it
    is. So slot i of a window-sized cache always holds the position p with
    p % window == i, and decode masks it as a ring. Every other leaf (``pos``,
    the RG-LRU and RWKV states) is O(1) in the length and stays as it is.
    The reference pads a windowed cache shorter than the window to
    ``pad_to``: the batcher then cannot splice it, and decode through it is
    no longer local.
    """

    def grow(x, target):  # x: (L, B, S, KV, hd), grown along S
        if x.shape[-3] >= target:
            return x
        out = x.new_zeros(x.shape[:-3] + (target,) + x.shape[-2:])
        out.narrow(-3, 0, x.shape[-3]).copy_(x)
        return out

    out = {}
    for si, (unit, _) in enumerate(segments):
        seg = cache[f"seg{si}"]
        out[f"seg{si}"] = {}
        for uj, kind in enumerate(unit):
            window = _window(cfg, kind)
            target = min(window, pad_to) if window else pad_to
            out[f"seg{si}"][f"u{uj}"] = {
                k: (grow(v, target) if k in ("k", "v") else v) for k, v in seg[f"u{uj}"].items()
            }
    return out


def _cache_pos(cache, batch: int) -> torch.Tensor:
    """Per-sequence decode positions (B,): the max over every 'pos' leaf.

    Leaves are (L, B), stacked per segment; layers advance together, so
    the max across layers is exact. A cache with no 'pos' leaf (RG-LRU
    or RWKV state only) gives zeros, as in the reference: those layers take
    no positions."""
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
    if not poses:
        return torch.zeros((batch,), dtype=torch.int32, device=_any_leaf(cache).device)
    out = poses[0]
    for p in poses[1:]:
        out = torch.maximum(out, p)
    return out


def _any_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree
