"""Mixture-of-Experts: the top-k router and two dispatch engines.

Counterpart of ``repro.models.moe``, plain functions on tensors with the
reference's param names and layouts (``moe/router`` (d, E),
``moe/experts/w_gate``, ``w_up`` (E, d, ff), ``w_down`` (E, ff, d),
``moe/shared/*``), so the JAX package's tree loads as it is.

``einsum`` (GShard): tokens in groups of ``moe_group_size``, capacity-bounded
slots filled rank by rank, the tail past G·S given no expert output.
``sort``: group-local, slots filled in the order of a stable sort by expert.
Both keep the reference's slots, drops and rounding points. The slot tables
come from a stable sort and binary search, and the einsum engine's one-hot
products are the gathers they amount to (each slot holds one token). Where
no assignment can drop (the sort engine with capacity S, as ``moe_block``'s
dropless path runs it), row t of every expert holds token t itself, so no
slot table is built. ``moe_block`` dispatches as the reference does
without a mesh: dropless ``sort`` for B·S <= 1024 tokens, else the config's
engine, ``einsum`` for ``moe_impl`` "einsum" and "a2a". The reference's
``_moe_a2a`` runs only under a mesh with a model axis; the port has no mesh
(ROADMAP Queue 1 item 11), so that engine is not here.

Two rules keep the results those of the reference, and the same on every run:

- ties: the router picks its k experts by a stable descending sort, so among
  equal probabilities the lower expert id wins, as with ``jax.lax.top_k``
  (``torch.topk`` promises no order for ties);
- the order of every sum: each token's k weighted expert outputs are gathered
  and added in float32 one after another in ascending expert id, the order in
  which the reference's scatter applies them. The gathers' gradients are
  gathers too (``_GatherRows``): a token's gradient adds its kept slots'
  gradients in float32 in ascending expert id and rounds once, as the
  reference's one-hot contraction accumulates them; a slot's gradient is its
  one assignment's; the router weights' permutation is undone by its inverse.
  Only the dropless combine keeps ``index_select``, whose gradient writes
  each row once. So no sum is left to the order of a scatter, forward or
  backward, on the CPU or on the card.

``_moe_sort.calls`` and ``_moe_einsum.calls`` count each engine's calls;
callers read and reset them directly.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Tuple

import torch

from .layers import _ACTS, ParamStore, dense, glu_mlp

__all__ = ["init_moe", "moe_block"]

# the largest B·S that moe_block dispatches dropless through the sort engine
DROPLESS_TOKENS = 1024

_CALLS_LOCK = threading.Lock()


def _count_call(engine) -> None:
    with _CALLS_LOCK:  # engines run on several handler threads of one worker
        engine.calls += 1


def init_moe(store: ParamStore, name: str, cfg) -> None:
    sub = store.sub(name)
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    sub.param("router", (d, E), scale=0.02)
    e = sub.sub("experts")
    e.param("w_gate", (E, d, ff))
    e.param("w_up", (E, d, ff))
    e.param("w_down", (E, ff, d))
    if cfg.num_shared_experts:
        s = sub.sub("shared")
        sff = ff * cfg.num_shared_experts
        s.param("w_gate", (d, sff))
        s.param("w_up", (d, sff))
        s.param("w_down", (sff, d))


def _router(x_flat: torch.Tensor, p: Dict[str, Any], cfg, with_aux: bool = True):
    """x_flat (T, d) -> (weights (T, k) in x's dtype, expert ids (T, k), aux loss).

    Without ``with_aux`` the aux loss is 0.0 and not computed: only the training loss
    reads it (the reference's jitted prefill and decode drop it unused)."""
    logits = dense(x_flat, p["router"]).float()  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    k, E = cfg.num_experts_per_tok, cfg.num_experts
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = top[:, :k], idx[:, :k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    aux = 0.0
    if with_aux:  # Switch-style load balance: E · Σ_e f_e · P_e, f from integer counts
        _, f = _sorted_counts(torch.sort(idx.reshape(1, -1)).values, E)
        f = f[0].float() / max(idx.numel(), 1)
        aux = E * torch.sum(f * probs.mean(0)) * cfg.router_aux_coef
    return weights.to(x_flat.dtype), idx, aux


def _sorted_counts(e_sorted: torch.Tensor, E: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(G, A) expert ids sorted along A -> (the first index of each expert, its count),
    each (G, E), by binary search: no atomics, no device sync."""
    experts = torch.arange(E, device=e_sorted.device).expand(e_sorted.shape[0], E).contiguous()
    starts = torch.searchsorted(e_sorted, experts)
    return starts, torch.searchsorted(e_sorted, experts, right=True) - starts


def _expert_ffn(h: torch.Tensor, ep: Dict[str, Any], cfg) -> torch.Tensor:
    """h (E, C, d) -> (E, C, d): each expert's GLU FFN, its products summed in float32
    and rounded to h's dtype, as the reference's ``preferred_element_type`` einsums."""
    actf = _ACTS[cfg.act]

    def bmm(a, w):
        if w.dtype != a.dtype:  # the reference's einsum promotes mixed operands
            return torch.bmm(a.float(), w.float()).to(a.dtype)
        return torch.bmm(a, w)

    return bmm(actf(bmm(h, ep["w_gate"])) * bmm(h, ep["w_up"]), ep["w_down"])


def _slots(e: torch.Tensor, E: int, cap: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Slot tables of one dispatch. ``e`` (G, A): each assignment's expert, in the order
    in which the assignments fill their experts' slots (the first ``cap`` of an expert
    are kept, the rest dropped).

    Returns ``pos`` (G, A), each assignment's position among its expert's; ``keep``
    (G, A), ``pos < cap``; and ``src`` (G, E, cap), the assignment each slot holds, ``A``
    where the slot is empty. By a stable sort and binary search: no atomics, no sync.
    """
    G, A = e.shape
    order = torch.argsort(e, dim=-1, stable=True)  # assignments grouped by expert, in order
    e_sorted = e.gather(1, order)
    starts, counts = _sorted_counts(e_sorted, E)
    pos_sorted = torch.arange(A, device=e.device) - starts.gather(1, e_sorted)
    pos = pos_sorted.gather(1, torch.argsort(order, dim=-1))  # back to assignment order
    c = torch.arange(cap, device=e.device)
    at = (starts[..., None] + c).clamp(max=A - 1).reshape(G, E * cap)
    src = torch.where(c < counts[..., None], order.gather(1, at).reshape(G, E, cap), A)
    return pos, pos < cap, src


class _GatherRows(torch.autograd.Function):
    """``x[table]``, a zero row where an entry is ``len(x)``, whose gradient is a gather by
    the inverse table ``inv`` (R, J): row r of x's gradient adds rows ``inv[r, 0]``,
    ``inv[r, 1]``, ... of the output's gradient in that order (an entry ``len(table)`` adds
    nothing), in float32, and rounds once to x's dtype. ``index_select``'s gradient would
    scatter instead, its adds to a row in an order of the device's choosing."""

    @staticmethod
    def forward(ctx, x, table, inv):
        ctx.save_for_backward(inv)
        return _rows(x, table)

    @staticmethod
    def backward(ctx, grad):
        (inv,) = ctx.saved_tensors
        rows = _rows(grad, inv.reshape(-1)).reshape(*inv.shape, grad.shape[-1])
        if inv.shape[1] == 1:
            return rows[:, 0], None, None
        acc = rows[:, 0].float()
        for j in range(1, inv.shape[1]):
            acc = acc + rows[:, j].float()
        return acc.to(grad.dtype), None, None


def _rows(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Rows of x (R, d) by ``table``, a zero row where an entry is R."""
    return torch.cat([x, x.new_zeros(1, x.shape[-1])]).index_select(0, table)


def _expert_order(idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each token's k assignments in ascending expert id, as flat tables over N·k: ``perm``,
    the assignment t·k + r at each place t·k + j of that order, and ``place``, its inverse."""
    N, k = idx.shape
    base = k * torch.arange(N, device=idx.device)[:, None]
    order = torch.argsort(idx, dim=-1)  # a token's k experts are distinct
    return (base + order).reshape(-1), (base + torch.argsort(order, dim=-1)).reshape(-1)


def _in_expert_order(weights, perm, place) -> torch.Tensor:
    """The router weights (N, k) in each token's ascending expert id; their gradient is put
    back in the router's order by the inverse permutation."""
    return _GatherRows.apply(weights.reshape(-1, 1), perm, place[:, None]).reshape(weights.shape)


def _group_base(G: int, cap: int, device) -> torch.Tensor:
    """(G, 1, 1): the first row of each group's slots within an expert's rows."""
    return (cap * torch.arange(G, device=device))[:, None, None]


def _dispatch_combine(x_rows, asg, row, keep, weights, idx, p, cfg, round_products):
    """Dispatch, the experts, and the combine of one capacity-bounded engine.

    ``x_rows`` (N, d): the tokens; ``asg`` (G, E, cap): the assignment t·k + r each slot
    holds (N·k where empty); ``row``, ``keep`` (N, k): each assignment's row of the experts'
    (E, G·cap) slots and whether it was kept (a dropped one points at a kept row and gets a
    zero weight, as the reference's one-hot combine). Returns (N, d) in x's dtype.
    """
    N, d = x_rows.shape
    k = idx.shape[1]
    perm, place = _expert_order(idx)
    row, keep = row.reshape(-1)[perm].reshape(N, k), keep.reshape(-1)[perm].reshape(N, k)
    slots = asg.transpose(0, 1).reshape(-1)  # expert-major, as the experts' rows
    # each slot's token, gathered; a token's gradient gathers its kept rows in expert order
    xs = _GatherRows.apply(x_rows, slots // k, torch.where(keep, row, slots.numel()))
    h = _expert_ffn(xs.reshape(cfg.num_experts, -1, d), p["experts"], cfg)
    held = torch.cat([place, place.new_full((1,), N * k)])[slots]  # a row's assignment, sorted
    w = _in_expert_order(weights, perm, place)
    return _combine(h, row, w * keep.to(w.dtype), held, round_products, x_rows.dtype)


def _combine(h, row, w, held, round_products: bool, dtype):
    """Each token's weighted expert outputs, added in float32 in ascending expert id.

    ``h`` (E, R, d): the experts' outputs; ``row``, ``w`` (N, k): each assignment's row of
    ``h`` flattened to (E·R, d) and its router weight (zero where dropped), in ascending
    expert id; ``held`` (E·R,): the place t·k + j of the one kept assignment each row holds
    (N·k where none), by which a row's gradient is gathered, or None where no two
    assignments share a row (the dropless path: ``index_select``'s gradient then writes
    each row once). With ``round_products`` each product of a row and its weight is rounded
    to ``dtype`` before the float32 sum (the sort engine's multiply in the activation
    dtype); without, it is exact (the einsum engine's float32 contraction). Returns (N, d)
    in ``dtype``.
    """
    d = h.shape[-1]
    N, k = row.shape
    flat = h.reshape(-1, d)
    if held is None:
        rows = flat.index_select(0, row.reshape(-1))
    else:
        rows = _GatherRows.apply(flat, row.reshape(-1), held[:, None])
    rows, w = rows.reshape(N, k, d), w.reshape(N, k, 1)
    contrib = (rows * w).float() if round_products else rows.float() * w.float()
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    return out.to(dtype)


# --------------------------------------------------------------------------
# engine 1: GShard dispatch, slots filled rank by rank
# --------------------------------------------------------------------------


def _moe_einsum(x_flat, weights, idx, p, cfg):
    _count_call(_moe_einsum)
    T, d = x_flat.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    G = max(1, T // cfg.moe_group_size)
    S = T // G
    cap = max(1, int(S * k / E * cfg.moe_capacity_factor))
    n = G * S
    ig = idx[:n].reshape(G, S, k)
    # the reference fills every expert's slots with rank 0 of all tokens, then rank 1, ...
    pos, keep, src = _slots(ig.transpose(1, 2).reshape(G, k * S), E, cap)
    pos, keep = (t.reshape(G, k, S).transpose(1, 2) for t in (pos, keep))  # (G, S, k)
    row = ig * (G * cap) + _group_base(G, cap, x_flat.device) + torch.where(keep, pos, 0)
    # slot a = r·S + s of group g holds assignment (g·S + s)·k + r
    tok = S * torch.arange(G, device=x_flat.device)[:, None, None] + src % S
    asg = torch.where(src < k * S, tok * k + src // S, n * k)
    out = _dispatch_combine(x_flat[:n], asg, row, keep, weights[:n], idx[:n], p, cfg, False)
    if n < T:  # the tail past G·S gets no expert output
        out = torch.cat([out, x_flat.new_zeros(T - n, d)])
    return out


_moe_einsum.calls = 0


# --------------------------------------------------------------------------
# engine 2: group-local sort dispatch
# --------------------------------------------------------------------------


def _moe_sort(x_flat, weights, idx, p, cfg, cap_override: int = 0):
    _count_call(_moe_sort)
    T, d = x_flat.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    S = min(4096, T)
    while T % S:
        S //= 2
    G = T // S
    if cap_override:
        cap = min(S, cap_override)  # per-group dropless bound is S
    else:
        cap = max(1, min(S, int(S * k / E * cfg.moe_capacity_factor)))
    if cap == S:
        # Dropless: an expert gets at most S of a group's tokens, so every assignment keeps
        # a slot. Row t of every expert then takes token t itself: a chosen expert's row
        # is the same product as in its sorted slot (each row of a product is its own), and
        # the other rows are never read. The products' shape is the reference's, (E, T, d).
        h = _expert_ffn(x_flat.expand(E, T, d), p["experts"], cfg)
        perm, place = _expert_order(idx)
        tokens = torch.arange(T, device=x_flat.device)[:, None]
        row = (idx * T + tokens).reshape(-1)[perm].reshape(T, k)
        return _combine(h, row, _in_expert_order(weights, perm, place), None, True, x_flat.dtype)
    ig = idx.reshape(G, S, k)
    pos, keep, src = _slots(ig.reshape(G, S * k), E, cap)  # slots filled token by token
    pos, keep = pos.reshape(G, S, k), keep.reshape(G, S, k)
    row = ig * (G * cap) + _group_base(G, cap, x_flat.device) + torch.where(keep, pos, 0)
    # slot a = s·k + r of group g holds assignment g·S·k + a
    asg = torch.where(src < S * k, src + _group_base(G, S * k, x_flat.device), T * k)
    return _dispatch_combine(x_flat, asg, row, keep, weights, idx, p, cfg, True)


_moe_sort.calls = 0


def moe_block(
    x: torch.Tensor, p: Dict[str, Any], cfg, with_aux: bool = True
) -> Tuple[torch.Tensor, Any]:
    """x (B, S, d) -> (out (B, S, d), aux loss; 0.0 without ``with_aux``).

    B·S <= 1024 tokens (every decode step, short prompts) dispatch dropless through the
    sort engine; more through the config's engine, as the reference does with no mesh.
    """
    B, S, d = x.shape
    x_flat = x.reshape(B * S, d)
    weights, idx, aux = _router(x_flat, p, cfg, with_aux)
    if B * S <= DROPLESS_TOKENS:
        out = _moe_sort(x_flat, weights, idx, p, cfg, cap_override=B * S)
    elif cfg.moe_impl == "sort":
        out = _moe_sort(x_flat, weights, idx, p, cfg)
    else:
        out = _moe_einsum(x_flat, weights, idx, p, cfg)
    if cfg.num_shared_experts:
        out = out + glu_mlp(x_flat, p["shared"], cfg.act, glu=True)
    return out.reshape(B, S, d), aux
