"""Plain PyTorch versions of the port's kernels.

They are the CPU path of the model (``ops`` dispatches here for a tensor
on the CPU) and the yardstick the Hopper kernels are held against on the
card. The math is that of ``repro.kernels.ref``.

Attention: float32 logits, masked logits set to -1e30, query positions
right-aligned to the keys (``qpos = i + Sk - Sq``), GQA through the KV head
``h // g``, and a value head dim that may differ from the key head dim (MLA).
The forward can also return each row's logsumexp, the one value its
backward keeps besides the inputs and the output; the backward is the
FlashAttention-2 form, recomputing the probabilities from it
(``flash_attention_bwd_ref``; float64 throughout for a float64 input).
``flash_attention_bwd_split_ref`` is the same backward in the decomposition of
the bfloat16 kernels' "split" builds (head dims above 128): tiles of 64 rows,
each key tile's walk cut into parts whose partials are summed in order; the
walks and their cut are the wrapper's own (``flash_attention.bwd_split_walks``,
``bwd_split_spans``, ``bwd_dq_walks``), which it imports.

Cached decode: one query token a slot against its cache (B, Sc, KV, D), the
logits and the softmax in float32, keys masked to -1e30 past the slot's
position, or outside the window when the cache is a ring of ``window`` slots.

RG-LRU: ``h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 0)) * x_t`` with the
state in float32, h returned in the dtype of x and the final state in
float32. ``rglru_ref`` steps through time; ``rglru_scan_ref`` is the
associative-scan form (torch has no ``associative_scan``: it doubles the
span ``log2(T)`` times, Hillis-Steele, with the reference's combine).
``rglru_bwd_ref`` is the gradient: a walk back through time from the
forward's float32 states, which it recomputes.

WKV6 (RWKV6 "Finch"): per head, with the K x V state S in float32,
``o_t = (r_t * u)^T (k_t v_t^T) + r_t^T S_{t-1}`` and
``S_t = diag(w_t) S_{t-1} + k_t v_t^T``. ``wkv6_ref`` steps through time;
``wkv6_chunked_ref`` is the chunked form the Hopper kernel computes, with
the reference's per-chunk order of operations. Both return the output in
r's dtype and the state in float32 (``wkv6_ref`` keeps a float64 input in
float64 throughout: the yardstick of the gradients). ``wkv6_bwd_ref`` is the
gradient in the chunked form, walking the chunks back from the forward's
chunk-start states, which it recomputes; ``wkv6_bwd_split_ref`` is the same
gradient in the Hopper kernels' decomposition: the two state walks first,
then each chunk's gradients from its own chunk-start state and chunk-end
state gradient alone, in any order.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = [
    "flash_attention_ref",
    "flash_attention_bwd_ref",
    "flash_attention_bwd_split_ref",
    "flash_attention_dense_ref",
    "decode_attention_ref",
    "rglru_ref",
    "rglru_scan_ref",
    "rglru_bwd_ref",
    "wkv6_ref",
    "wkv6_chunked_ref",
    "wkv6_bwd_ref",
    "wkv6_bwd_split_ref",
]

_NEG_INF = -1e30


def _mask(sq: int, kpos: torch.Tensor, sk: int, causal: bool, window: Optional[int]):
    """(Sq, len(kpos)) validity of each (query, key) pair."""
    qpos = torch.arange(sq, device=kpos.device)[:, None] + (sk - sq)
    valid = (kpos < sk)[None, :].expand(sq, kpos.numel())
    if causal:
        valid = valid & (kpos[None, :] <= qpos)
    if window is not None:
        valid = valid & (kpos[None, :] > qpos - window)
    return valid


def flash_attention_dense_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """O(S²)-memory oracle for small shapes.

    q: (B, Hq, Sq, D), k: (B, Hkv, Sk, D), v: (B, Hkv, Sk, Dv); Hq % Hkv == 0.
    ``window``: each query attends to keys in (pos - window, pos].
    """
    d = q.shape[-1]
    g = q.shape[1] // k.shape[1]
    scale = scale if scale is not None else d**-0.5
    sq, sk = q.shape[2], k.shape[2]
    kx = k.repeat_interleave(g, dim=1).float()
    vx = v.repeat_interleave(g, dim=1).float()
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx) * scale
    valid = _mask(sq, torch.arange(sk, device=q.device), sk, causal, window)
    logits = torch.where(valid, logits, torch.full_like(logits, _NEG_INF))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vx).to(q.dtype)


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    block_k: int = 512,
    return_lse: bool = False,
    out_dtype: Optional[torch.dtype] = None,
):
    """Blocked online-softmax attention: the Hopper kernel's plain version.

    Keys are visited ``block_k`` at a time with a running max, sum and
    float32 accumulator, as the kernel does; memory is O(Sq·D + block_k·D)
    per head. Padded keys (past Sk) are masked like any other. With
    ``return_lse`` it returns (out, lse): lse (B, Hq, Sq) float32 is each
    row's ``m + log(l)``, the logsumexp of its scaled, masked logits; the
    output is the same either way. The output is rounded once from float32
    to ``out_dtype`` (q's dtype by default).
    """
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = hq // hkv
    scale = scale if scale is not None else d**-0.5
    qf = q.float()
    m = torch.full((b, hq, sq), _NEG_INF, dtype=torch.float32, device=q.device)
    l_sum = torch.zeros((b, hq, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hq, sq, dv), dtype=torch.float32, device=q.device)
    for start in range(0, sk, block_k):
        kpos = torch.arange(start, start + block_k, device=q.device)
        kblk = k[:, :, start : start + block_k].float()
        vblk = v[:, :, start : start + block_k].float()
        pad = block_k - kblk.shape[2]
        if pad:
            kblk = torch.nn.functional.pad(kblk, (0, 0, 0, pad))
            vblk = torch.nn.functional.pad(vblk, (0, 0, 0, pad))
        kq = kblk.repeat_interleave(g, dim=1)
        vq = vblk.repeat_interleave(g, dim=1)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kq) * scale
        valid = _mask(sq, kpos, sk, causal, window)
        s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l_sum = l_sum * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vq)
        m = m_new
    out = (acc / torch.clamp(l_sum[..., None], min=1e-37)).to(out_dtype or q.dtype)
    if return_lse:
        return out, m + torch.log(l_sum)
    return out


def flash_attention_bwd_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    block_k: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention backward, FlashAttention-2 form: the Hopper kernels' plain version.

    From the forward's output ``out`` (q's dtype or float32) and logsumexp ``lse``
    (B, Hq, Sq) float32: Δ = rowsum(dO∘O); then, ``block_k`` keys at a time as the
    forward walks them, P = exp(S·scale − lse) (0 where masked), dV = Pᵀ·dO,
    dS = P∘(dP − Δ) with dP = dO·Vᵀ, dQ = dS·K·scale and dK = dSᵀ·Q·scale. dK and dV
    are summed over the g query heads of each KV head. All in float32 (float64 for a
    float64 q);
    returns (dq, dk, dv) in the dtypes of q, k and v. It is the function the
    reference's custom VJP computes (``jax.vjp`` of the blocked forward), by
    another route.
    """
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = hq // hkv
    scale = scale if scale is not None else d**-0.5
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    qf, dof = q.to(ct), dout.to(ct)
    delta = (dof * out.to(ct)).sum(dim=-1)  # (B, Hq, Sq)
    lse_f = lse.to(ct)[..., None]
    dq = torch.zeros((b, hq, sq, d), dtype=ct, device=q.device)
    dk = torch.zeros((b, hkv, sk, d), dtype=ct, device=q.device)
    dvv = torch.zeros((b, hkv, sk, dv), dtype=ct, device=q.device)
    for start in range(0, sk, block_k):
        stop = min(start + block_k, sk)
        kpos = torch.arange(start, stop, device=q.device)
        kq = k[:, :, start:stop].to(ct).repeat_interleave(g, dim=1)
        vq = v[:, :, start:stop].to(ct).repeat_interleave(g, dim=1)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kq) * scale
        valid = _mask(sq, kpos, sk, causal, window)
        p = torch.where(valid, torch.exp(s - lse_f), torch.zeros_like(s))
        dp = torch.einsum("bhqd,bhkd->bhqk", dof, vq)
        ds = p * (dp - delta[..., None])
        dq += torch.einsum("bhqk,bhkd->bhqd", ds, kq) * scale
        n = stop - start
        dk_h = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
        dv_h = torch.einsum("bhqk,bhqd->bhkd", p, dof)
        dk[:, :, start:stop] = dk_h.reshape(b, hkv, g, n, d).sum(dim=2)
        dvv[:, :, start:stop] = dv_h.reshape(b, hkv, g, n, dv).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dvv.to(v.dtype)


def flash_attention_bwd_split_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    parts: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_bwd_ref` in the decomposition of the bfloat16 kernels'
    split builds (``flash_bwd_bf16_dkdv_split_kernel``, ``flash_bwd_bf16_dq_split_kernel``,
    ``flash_bwd_bf16_dkdv_reduce_kernel``).

    dK and dV: for each tile of 64 keys, its walk over the group's (query head, query
    tile) pairs, heads in order, each its tiles in order (``bwd_split_walks``), is cut
    into ``parts`` spans (``bwd_split_spans``); each span's partial is
    summed tile by tile from zero, and the partials are added in part order, dK then
    times the scale. dQ: for each tile of 64 query rows, the key tiles its rows see, in
    order, times the scale at the end. For a bfloat16 q, P and dS are rounded to bfloat16
    where they enter dV, dK and dQ (P kept in float32 in dS), as the kernels round them;
    float32 otherwise, float64 for a float64 q. Returns (dq, dk, dv) in the dtypes of q,
    k and v.
    """
    # the kernels' walks, planned beside their wrapper (which imports this module)
    from .flash_attention import BWD_SPLIT_TILE, bwd_dq_walks, bwd_split_spans, bwd_split_walks

    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g, t = hq // hkv, BWD_SPLIT_TILE
    scale = scale if scale is not None else d**-0.5
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    if q.dtype == torch.bfloat16:
        operand = lambda x: x.bfloat16().to(ct)  # noqa: E731
    else:
        operand = lambda x: x  # noqa: E731
    qf, kf, vf, dof = (x.to(ct) for x in (q, k, v, dout))
    delta = (dof * out.to(ct)).sum(dim=-1)
    lse_c = lse.to(ct)

    def probs(qh, doh, lse_h, delta_h, kh, vh, rows, keys):
        """P and dS of query rows ``rows`` (heads as qh's) by keys ``keys``."""
        s = torch.einsum("bhid,bhjd->bhij", qh[:, :, rows], kh[:, :, keys]) * scale
        kpos = torch.arange(keys.start, keys.stop, device=q.device)
        valid = _mask(sq, kpos, sk, causal, window)[rows]
        p = torch.where(valid, torch.exp(s - lse_h[:, :, rows, None]), torch.zeros_like(s))
        dp = torch.einsum("bhid,bhjd->bhij", doh[:, :, rows], vh[:, :, keys])
        return p, p * (dp - delta_h[:, :, rows, None])

    # dK and dV: query head hh of the group is head hh of every KV head's group
    q5, do5 = qf.view(b, hkv, g, sq, d), dof.view(b, hkv, g, sq, dv)
    lse5, delta5 = lse_c.view(b, hkv, g, sq), delta.view(b, hkv, g, sq)
    dk = torch.zeros((b, hkv, sk, d), dtype=ct, device=q.device)
    dvv = torch.zeros((b, hkv, sk, dv), dtype=ct, device=q.device)
    for kt, (t_begin, per_head) in enumerate(bwd_split_walks(sq, sk, causal, window)):
        keys = slice(kt * t, min(kt * t + t, sk))
        n = keys.stop - keys.start
        total_k = total_v = None
        for lo, hi in bwd_split_spans(g * per_head, parts):
            part_k = torch.zeros((b, hkv, n, d), dtype=ct, device=q.device)
            part_v = torch.zeros((b, hkv, n, dv), dtype=ct, device=q.device)
            for idx in range(lo, hi):
                hh, ti = divmod(idx, per_head)
                rows = slice((t_begin + ti) * t, min((t_begin + ti) * t + t, sq))
                qh, doh = q5[:, :, hh], do5[:, :, hh]
                p, ds = probs(qh, doh, lse5[:, :, hh], delta5[:, :, hh], kf, vf, rows, keys)
                part_v = part_v + torch.einsum("bhij,bhid->bhjd", operand(p), doh[:, :, rows])
                part_k = part_k + torch.einsum("bhij,bhid->bhjd", operand(ds), qh[:, :, rows])
            total_k = part_k if total_k is None else total_k + part_k
            total_v = part_v if total_v is None else total_v + part_v
        dk[:, :, keys] = total_k * scale
        dvv[:, :, keys] = total_v

    # dQ: every query head against its KV head's keys
    kx, vx = kf.repeat_interleave(g, dim=1), vf.repeat_interleave(g, dim=1)
    dq = torch.zeros((b, hq, sq, d), dtype=ct, device=q.device)
    for qt, (kb, ke) in enumerate(bwd_dq_walks(sq, sk, causal, window)):
        rows = slice(qt * t, min(qt * t + t, sq))
        acc = torch.zeros((b, hq, rows.stop - rows.start, d), dtype=ct, device=q.device)
        for kt in range(kb, ke):
            keys = slice(kt * t, min(kt * t + t, sk))
            _, ds = probs(qf, dof, lse_c, delta, kx, vx, rows, keys)
            acc = acc + torch.einsum("bhij,bhjd->bhid", operand(ds), kx[:, :, keys])
        dq[:, :, rows] = acc * scale
    return dq.to(q.dtype), dk.to(k.dtype), dvv.to(v.dtype)


def decode_attention_ref(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos: torch.Tensor,
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """One decode step of GQA attention over a cache: the Hopper kernel's plain version.

    q (B, H, D); k_cache, v_cache (B, Sc, KV, D); pos (B,) the slot each sequence
    writes this step (its keys 0..pos are valid). A cache of ``window`` slots is a
    ring: slot i holds the position p with p % window == i, valid when it is among
    the last min(pos + 1, window) positions. Returns (B, H, D) in q's dtype.
    """
    b, h, d = q.shape
    sc, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    # (B, KV, g, 1, D) x (B, KV, 1, Sc, D): GQA without repeating the cache
    qf = q.float().reshape(b, kv, g, 1, d)
    kf = k_cache.float().permute(0, 2, 1, 3).unsqueeze(2)
    vf = v_cache.float().permute(0, 2, 1, 3).unsqueeze(2)
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * (d**-0.5)  # (B, KV, g, 1, Sc)
    idx = torch.arange(sc, device=q.device)
    if window and sc == window:
        ages = torch.remainder(pos[:, None] - idx[None, :], window)  # (B, Sc)
        valid = ages < torch.clamp(pos + 1, max=window)[:, None]
    else:
        valid = idx[None, :] <= pos[:, None]
    logits = logits.masked_fill(~valid[:, None, None, None, :], _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs, vf).to(q.dtype).reshape(b, h, d)


def _rglru_h0(x: torch.Tensor, initial_state: Optional[torch.Tensor]) -> torch.Tensor:
    if initial_state is None:
        return torch.zeros((x.shape[0], x.shape[2]), dtype=torch.float32, device=x.device)
    return initial_state.float()


def rglru_ref(
    x: torch.Tensor, a: torch.Tensor, *, initial_state: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential RG-LRU: the Hopper kernel's plain version.

    x: (B, T, W) gated input; a: (B, T, W) decay in (0, 1); initial_state
    (B, W) or None (zeros). Returns (h (B, T, W) in x's dtype, final state
    (B, W) float32). The arithmetic order is the kernel's: ``a*a``,
    ``1 - .``, max, sqrt, ``* x``, then ``a*h + .``, each rounded once.
    """
    xf, af = x.float(), a.float()
    gated = torch.sqrt(torch.clamp(1.0 - af * af, min=0.0)) * xf
    h = _rglru_h0(x, initial_state)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    for t in range(x.shape[1]):
        h = af[:, t] * h + gated[:, t]
        out[:, t] = h.to(x.dtype)
    return out, h


def rglru_bwd_ref(
    x: torch.Tensor,
    a: torch.Tensor,
    dh: torch.Tensor,
    *,
    initial_state: Optional[torch.Tensor] = None,
    dh_last: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The RG-LRU's gradient, walking back through time: the Hopper kernel's plain version.

    From x, a and initial_state (as :func:`rglru_ref` takes them), the gradient ``dh``
    (B, T, W) of h (in x's dtype) and ``dh_last`` (B, W) of the final state (None: zero),
    returns (dx in x's dtype, da float32, dh0 (B, W) float32; float64 throughout for a
    float64 x). With b_t = sqrt(max(1 - a_t², 0)) and the carried gradient c (dh_last at
    the start), from t = T-1 down to 0:
    ``g = dh_t + c``, ``dx_t = g * b_t``, ``da_t = g * (h_{t-1} - a_t * x_t / b_t)``,
    ``c = a_t * g``; dh0 is the last c. h_{t-1} is the forward's float32 state, recomputed
    here with :func:`rglru_ref`'s rounding. Each operation is rounded once, in the kernel's
    order. At a_t = 1 (b_t = 0), da_t is ±inf where x_t != 0 and NaN where x_t = 0, as
    ``jax.grad`` through the reference gives.
    """
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32  # float64: gradcheck
    xf, af = x.to(ct), a.to(ct)
    root = torch.sqrt(torch.clamp(1.0 - af * af, min=0.0))
    gated = root * xf
    h0 = _rglru_h0(x, None).to(ct) if initial_state is None else initial_state.to(ct)
    states = torch.empty(x.shape, dtype=ct, device=x.device)
    h = h0
    for t in range(x.shape[1]):
        h = af[:, t] * h + gated[:, t]
        states[:, t] = h
    carry = torch.zeros_like(h0) if dh_last is None else dh_last.to(ct)
    dx = torch.empty(x.shape, dtype=ct, device=x.device)
    da = torch.empty(x.shape, dtype=ct, device=x.device)
    for t in range(x.shape[1] - 1, -1, -1):
        g = dh[:, t].to(ct) + carry
        prev = states[:, t - 1] if t > 0 else h0
        dx[:, t] = g * root[:, t]
        da[:, t] = g * (prev - af[:, t] * xf[:, t] / root[:, t])
        carry = af[:, t] * g
    return dx.to(x.dtype), da, carry


def rglru_scan_ref(
    x: torch.Tensor, a: torch.Tensor, *, initial_state: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Associative-scan RG-LRU: the same result as :func:`rglru_ref`.

    Pairs (A, B) combine as (a1, b1) . (a2, b2) = (a1*a2, b1*a2 + b2), the
    reference's combine; after the scan h_t = B_t + A_t * h0.
    """
    af = a.float()
    bf = torch.sqrt(torch.clamp(1.0 - af * af, min=0.0)) * x.float()
    t_len, span = x.shape[1], 1
    while span < t_len:
        b_new = bf.clone()
        b_new[:, span:] = bf[:, :-span] * af[:, span:] + bf[:, span:]
        a_new = af.clone()
        a_new[:, span:] = af[:, :-span] * af[:, span:]
        af, bf, span = a_new, b_new, 2 * span
    if initial_state is not None:
        bf = bf + af * initial_state.float()[:, None, :]
    return bf.to(x.dtype), bf[:, -1].clone()


def _wkv_s0(r: torch.Tensor, v: torch.Tensor, initial_state: Optional[torch.Tensor]):
    if initial_state is None:
        b, h, _, kd = r.shape
        return torch.zeros((b, h, kd, v.shape[-1]), dtype=torch.float32, device=r.device)
    return initial_state if initial_state.dtype == torch.float64 else initial_state.float()


def wkv6_ref(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    *,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential oracle. r, k, w (B,H,T,K); v (B,H,T,V); u (H,K); w is the decay
    multiplier in (0, 1]. Returns (out (B,H,T,V) in r's dtype, state (B,H,K,V) float32;
    float64 throughout for a float64 r)."""
    ct = torch.float64 if r.dtype == torch.float64 else torch.float32
    rf, kf, vf, wf = r.to(ct), k.to(ct), v.to(ct), w.to(ct)
    ru = rf * u.to(ct)[None, :, None, :]
    s = _wkv_s0(r, v, initial_state).to(ct)
    out = torch.empty(v.shape, dtype=r.dtype, device=r.device)
    for t in range(r.shape[2]):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]  # (B,H,K,V)
        o = torch.einsum("bhk,bhkv->bhv", ru[:, :, t], kv) + torch.einsum(
            "bhk,bhkv->bhv", rf[:, :, t], s
        )
        s = wf[:, :, t, :, None] * s + kv
        out[:, :, t] = o.to(r.dtype)
    return out, s


def wkv6_chunked_ref(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    *,
    chunk: int = 16,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked form: the Hopper kernel's plain version, the same result as :func:`wkv6_ref`.

    Within a chunk, ``r^ = r D_{t-1}`` and ``k^ = k / D_t`` with ``D_t`` the
    running product of w, so the strictly lower ``(r^ k^T) v`` is the
    intra-chunk sum; ``r^ S`` carries the state in. A ragged T is padded with
    r = k = 0, w = 1 rows, which change neither the kept rows nor the state
    (the reference's ``ops.wkv6`` pads so).

    Range: the factored exponents stay inside float32 only while
    ``|sum of log w over a chunk|`` is below ~80; the model clamps log w to
    [-4, -1e-4], so chunk 16 gives at most 60.
    """
    b, h, t, kd = r.shape
    pad = (-t) % chunk
    rf, kf, vf, wf = r.float(), k.float(), v.float(), w.float()
    if pad:
        rf, kf, vf = (F.pad(x, (0, 0, 0, pad)) for x in (rf, kf, vf))
        wf = F.pad(wf, (0, 0, 0, pad), value=1.0)
    uf = u.float()[None, :, None, :]
    s = _wkv_s0(r, v, initial_state)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32, device=r.device), -1)
    outs = []
    for c0 in range(0, t + pad, chunk):
        rt, kt, vt, wt = (x[:, :, c0 : c0 + chunk] for x in (rf, kf, vf, wf))
        logw = torch.log(torch.clamp(wt, min=1e-38))
        cum = torch.cumsum(logw, dim=2)
        dt = torch.exp(cum)
        r_hat = rt * torch.exp(cum - logw)
        k_hat = kt / torch.clamp(dt, min=1e-30)
        cross = torch.matmul(r_hat, s)
        att = torch.matmul(r_hat, k_hat.transpose(-1, -2)) * tri
        intra = torch.matmul(att, vt)
        diag = (rt * uf * kt).sum(-1, keepdim=True) * vt
        outs.append(cross + intra + diag)
        k_scaled = kt * torch.exp(cum[:, :, -1:, :] - cum)
        s = dt[:, :, -1, :, None] * s + torch.matmul(k_scaled.transpose(-1, -2), vt)
    out = torch.cat(outs, dim=2)[:, :, :t]
    return out.to(r.dtype), s


def wkv6_bwd_ref(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    dout: torch.Tensor,
    *,
    initial_state: Optional[torch.Tensor] = None,
    ds_last: Optional[torch.Tensor] = None,
    chunk: int = 16,
) -> Tuple[torch.Tensor, ...]:
    """The gradient of :func:`wkv6_chunked_ref`: the Hopper backward kernel's plain version.

    From r, k, v, w, u and initial_state (as the forward takes them), the gradient ``dout``
    (B,H,T,V) of the output and ``ds_last`` (B,H,K,V) float32 of the final state (None:
    zero), returns (dr, dk, dv in r's dtype, dw (B,H,T,K) float32, du (H,K) in u's dtype,
    dS0 (B,H,K,V) float32; float64 throughout for a float64 r). dw is the gradient of w,
    the decay multiplier, as the forward takes it: that of log w over w.

    In the kernel's order, in the analytic chunked form (chunk 16). The chunk-start states
    S_c are recomputed first, as the forward walks them. Then the chunks are walked back,
    carrying dS, the gradient of the state at the chunk's end (``ds_last`` at the start).
    Within a chunk, with cum the inclusive cumulative sum of log w over its rows, excl = cum
    - log w the exclusive one, last its last row, r^ = r exp(excl), k^ = k exp(-cum), the
    update weights kw = k exp(last - cum), vd[t,s] = dout_t . v_s and A = r^ k^T, from the
    strictly lower 16 x 16 tile (s < t):

        x  = dout S_c^T + strict_lower(vd) k^   dr = exp(excl) x + u vd[t,t] k
        y  = strict_lower(vd)^T r^              dk = exp(-cum) y + exp(last - cum) (dS v)
                                                     + u vd[t,t] r
        dv = strict_lower(A)^T dout + (r u . k) dout + kw dS
        du = sum over batch and time of r k vd[t,t]
        dS <- exp(last) dS + r^T dout                (the gradient of S_c)

    dw comes from the gradients of the cumulative log decays: log w_m enters excl_t for t > m
    and cum_s for s >= m. Summed over the chunk's rows, the gradient of log w_m is

        sum_{t>m} r^_t . (S_c dout_t)                 the cross term (a reverse cumulative sum)
      + sum_{s<m<t} r^_t k^_s vd[t,s]                 the intra-chunk pairs that straddle m
      + exp(last) sum_j dS S_c + sum_{s<m} kw_s (dS v_s)   the state update (a cumulative sum)

    and dw = that / w. The walk back through dS carries every later chunk's part, so each
    sum runs over the chunk's own rows. Each holds only terms that depend on log w_m: the
    shorter form, a reverse cumulative sum of r^ x - k^ y - kw (dS v), adds pairs that cancel
    (the gradients of excl_t and cum_s of a pair s < t with m <= s), and loses two digits
    where the decays are deep (1.5e-5 relative against float64 at log w in [-4, -3.9]).

    Three traps: r is weighted by the exclusive product D_{t-1} = exp(excl_t), while the
    state update weights k by the inclusive one, so r's sums start a row after m; the bonus
    term (u) does not depend on w, so it stays out of dw; and the update's exp(last - cum_s)
    depends on every log w of the chunk through last, so exp(last) sum_j dS S_c reaches
    every row's dw.

    Range: every factor is an exponent of a cumulative sum or of a difference of two, and
    nothing is divided by D_t^2. Autodiff through ``k / D_t`` divides by D_t^2, which
    underflows in float32 once a chunk's sum of log w falls below about -43.7 and makes the
    reference's dw NaN there; here every entry is finite over the model's clamp log w in
    [-4, -1e-4] (chunk sums down to -64). A ragged T is padded as in the forward (r = k = 0,
    w = 1; dout = 0).
    """
    b, h, t, kd = r.shape
    ct = torch.float64 if r.dtype == torch.float64 else torch.float32
    pad = (-t) % chunk
    rf, kf, vf, wf, gf = (x.to(ct) for x in (r, k, v, w, dout))
    if pad:
        rf, kf, vf, gf = (F.pad(x, (0, 0, 0, pad)) for x in (rf, kf, vf, gf))
        wf = F.pad(wf, (0, 0, 0, pad), value=1.0)
    uf = u.to(ct)[None, :, None, :]
    n = (t + pad) // chunk
    tri = torch.tril(torch.ones((chunk, chunk), dtype=ct, device=r.device), -1)  # [t, s]: s < t
    rows = [slice(c * chunk, (c + 1) * chunk) for c in range(n)]

    def factors(c):
        logw = torch.log(torch.clamp(wf[:, :, rows[c]], min=1e-38))
        cum = torch.cumsum(logw, dim=2)
        last = cum[:, :, -1:, :]
        return cum - logw, cum, last, torch.exp(last - cum)

    # the state at each chunk's start, as the forward walks it
    s = _wkv_s0(r, v, initial_state).to(ct)
    states = []
    for c in range(n):
        _, _, last, decay = factors(c)
        states.append(s)
        kw = (kf[:, :, rows[c]] * decay).transpose(-1, -2)
        s = torch.exp(last)[:, :, 0, :, None] * s + torch.matmul(kw, vf[:, :, rows[c]])
    ds = torch.zeros_like(s) if ds_last is None else ds_last.to(ct)
    dr, dk, dw = (torch.empty(rf.shape, dtype=ct, device=r.device) for _ in range(3))
    dv = torch.empty(vf.shape, dtype=ct, device=r.device)
    du = torch.zeros((b, h, kd), dtype=ct, device=r.device)
    for c in range(n - 1, -1, -1):
        rt, kt, vt, gt = (x[:, :, rows[c]] for x in (rf, kf, vf, gf))
        excl, cum, last, decay = factors(c)
        kw = kt * decay
        r_hat, k_hat = rt * torch.exp(excl), kt * torch.exp(-cum)
        vdot = torch.matmul(gt, vt.transpose(-1, -2))  # [t, s] = dout_t . v_s
        lower = vdot * tri
        diag = torch.diagonal(vdot, dim1=-2, dim2=-1)[..., None]  # (B,H,C,1)
        att = torch.matmul(r_hat, k_hat.transpose(-1, -2)) * tri
        bonus = (rt * uf * kt).sum(-1, keepdim=True)
        q = torch.matmul(gt, states[c].transpose(-1, -2))  # [t, i] = sum_j S_c[i, j] dout_t[j]
        x = q + torch.matmul(lower, k_hat)
        y = torch.matmul(lower.transpose(-1, -2), r_hat)
        p = torch.matmul(vt, ds.transpose(-1, -2))  # [s, i] = sum_j dS[i, j] v_s[j]
        dr[:, :, rows[c]] = torch.exp(excl) * x + uf * diag * kt
        dk[:, :, rows[c]] = torch.exp(-cum) * y + decay * p + uf * diag * rt
        dv[:, :, rows[c]] = (
            torch.matmul(att.transpose(-1, -2), gt) + bonus * gt + torch.matmul(kw, ds)
        )
        du += (rt * kt * diag).sum(2)
        # the gradient of log w_m, from terms that depend on it only
        pairs = r_hat[:, :, :, None, :] * k_hat[:, :, None, :, :] * lower[..., None]
        straddle = (_exclusive_cumsum(pairs, 3) * tri[..., None]).sum(2)  # s < m < t
        held = torch.exp(last) * (ds * states[c]).sum(-1)[:, :, None, :]
        dw[:, :, rows[c]] = (
            _exclusive_cumsum(r_hat * q, 2, reverse=True)
            + straddle
            + held
            + _exclusive_cumsum(kw * p, 2)
        )
        ds = torch.exp(last)[:, :, 0, :, None] * ds + torch.matmul(r_hat.transpose(-1, -2), gt)
    dw = torch.where(wf > 1e-38, dw / wf, torch.zeros_like(dw))
    du_sum = du[0]
    for i in range(1, b):  # over the batch in order, as the kernel adds its partials
        du_sum = du_sum + du[i]
    kept = (slice(None), slice(None), slice(0, t))
    return (
        dr[kept].to(r.dtype),
        dk[kept].to(r.dtype),
        dv[kept].to(r.dtype),
        dw[kept],
        du_sum.to(u.dtype),
        ds,
    )


#: runs of consecutive chunks in which the backward kernels sum du (``DU_SPLITS`` in
#: ``csrc/wkv6_bwd.cu``)
WKV6_DU_SPLITS = 16


def wkv6_bwd_split_ref(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    dout: torch.Tensor,
    *,
    initial_state: Optional[torch.Tensor] = None,
    ds_last: Optional[torch.Tensor] = None,
    chunk: int = 16,
    order: Optional[Sequence[int]] = None,
    matmul: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = torch.matmul,
) -> Tuple[torch.Tensor, ...]:
    """The gradient of :func:`wkv6_chunked_ref` in the decomposition of the Hopper backward
    kernels (``csrc/wkv6_bwd.cu``); returns what :func:`wkv6_bwd_ref` returns.

    Walk A runs the chunks forward from the initial state and keeps S_c, the state at each
    chunk's start; walk B runs them back from ``ds_last`` and keeps dS_c, the gradient of the
    state at each chunk's end, and ends at dS0. Then each chunk's dr, dk, dv, dw and du part
    come from its own rows, S_c and dS_c alone, the chunks taken in ``order`` (default: from
    the last): any order gives the same result. dlog w_m is summed as the kernel sums it:
    ((later + straddle) + held) + earlier, later = sum_{t>m} r^_t q_t from the chunk's end,
    straddle = sum_{t>m} r^_t sum_{s<m} k^_s vd[t, s], held = exp(last) sum_j dS S_c and
    earlier = sum_{s<m} kw_s p_s. du: for each batch row, the chunks in
    :data:`WKV6_DU_SPLITS` runs of consecutive chunks, each summed in order, the runs added
    in order, then the batch rows in order. ``matmul`` computes every product the kernels
    run on the tensor cores (the walks' updates, q, p, vd, r^ k^T, x's and y's products with
    the lower tile, att^T dout and kw dS), so a test can model their rounding.
    """
    b, h, t, kd = r.shape
    ct = torch.float64 if r.dtype == torch.float64 else torch.float32
    pad = (-t) % chunk
    rf, kf, vf, wf, gf = (x.to(ct) for x in (r, k, v, w, dout))
    if pad:
        rf, kf, vf, gf = (F.pad(x, (0, 0, 0, pad)) for x in (rf, kf, vf, gf))
        wf = F.pad(wf, (0, 0, 0, pad), value=1.0)
    uf = u.to(ct)[None, :, None, :]
    n = (t + pad) // chunk
    tri = torch.tril(torch.ones((chunk, chunk), dtype=ct, device=r.device), -1)  # [t, s]: s < t
    rows = [slice(c * chunk, (c + 1) * chunk) for c in range(n)]

    def factors(c):
        logw = torch.log(torch.clamp(wf[:, :, rows[c]], min=1e-38))
        cum = torch.cumsum(logw, dim=2)
        last = cum[:, :, -1:, :]
        return cum - logw, cum, last

    # walk A: the state at every chunk's start
    s = _wkv_s0(r, v, initial_state).to(ct)
    states = []
    for c in range(n):
        _, cum, last = factors(c)
        states.append(s)
        kw = kf[:, :, rows[c]] * torch.exp(last - cum)
        s = torch.exp(last)[:, :, 0, :, None] * s + matmul(kw.transpose(-1, -2), vf[:, :, rows[c]])
    # walk B: the gradient of the state at every chunk's end
    ds = torch.zeros_like(s) if ds_last is None else ds_last.to(ct)
    ds_end = [None] * n
    for c in range(n - 1, -1, -1):
        excl, _, last = factors(c)
        ds_end[c] = ds
        r_hat = rf[:, :, rows[c]] * torch.exp(excl)
        ds = torch.exp(last)[:, :, 0, :, None] * ds + matmul(r_hat.transpose(-1, -2), gf[:, :, rows[c]])
    # each chunk from its own rows, S_c and dS_c
    dr, dk, dw = (torch.empty(rf.shape, dtype=ct, device=r.device) for _ in range(3))
    dv = torch.empty(vf.shape, dtype=ct, device=r.device)
    du_part = torch.empty((b, h, n, kd), dtype=ct, device=r.device)
    for c in range(n - 1, -1, -1) if order is None else order:
        rt, kt, vt, gt = (x[:, :, rows[c]] for x in (rf, kf, vf, gf))
        excl, cum, last = factors(c)
        ee, ec, dec = torch.exp(excl), torch.exp(-cum), torch.exp(last - cum)
        r_hat, k_hat, kw = rt * ee, kt * ec, kt * dec
        s_c, ds_c = states[c], ds_end[c]
        vd = matmul(gt, vt.transpose(-1, -2))  # [t, s] = dout_t . v_s
        lower = vd * tri
        diag = torch.diagonal(vd, dim1=-2, dim2=-1)[..., None]  # (B,H,C,1)
        att = matmul(r_hat, k_hat.transpose(-1, -2)) * tri
        bonus = (rt * uf * kt).sum(-1, keepdim=True)
        q = matmul(gt, s_c.transpose(-1, -2))  # [t, i] = sum_j S_c[i, j] dout_t[j]
        p = matmul(vt, ds_c.transpose(-1, -2))  # [s, i] = sum_j dS_c[i, j] v_s[j]
        x = q + matmul(lower, k_hat)
        y = matmul(lower.transpose(-1, -2), r_hat)
        ukd = uf * diag
        dr[:, :, rows[c]] = ee * x + ukd * kt
        dk[:, :, rows[c]] = ec * y + dec * p + ukd * rt
        dv[:, :, rows[c]] = (matmul(att.transpose(-1, -2), gt) + bonus * gt) + matmul(kw, ds_c)
        du_part[:, :, c] = (rt * kt * diag).sum(2)
        later = _exclusive_cumsum(r_hat * q, 2, reverse=True)
        pairs = k_hat[:, :, None, :, :] * lower[..., None]  # [t, s, i]
        inner = _exclusive_cumsum(pairs, 3)  # [t, m, i] = sum_{s<m} k^_s vd[t, s]
        straddle = (r_hat[:, :, :, None, :] * inner * tri[..., None]).sum(2)  # over t > m
        held = torch.exp(last) * (ds_c * s_c).sum(-1)[:, :, None, :]
        earlier = _exclusive_cumsum(kw * p, 2)
        dw[:, :, rows[c]] = ((later + straddle) + held) + earlier
    dw = torch.where(wf > 1e-38, dw / wf, torch.zeros_like(dw))
    per = -(-n // WKV6_DU_SPLITS)
    du_sum = None
    for i in range(b):
        total = None
        for c0 in range(0, n, per):
            run = du_part[i, :, c0]
            for c in range(c0 + 1, min(n, c0 + per)):
                run = run + du_part[i, :, c]
            total = run if total is None else total + run
        du_sum = total if du_sum is None else du_sum + total
    kept = (slice(None), slice(None), slice(0, t))
    return (
        dr[kept].to(r.dtype),
        dk[kept].to(r.dtype),
        dv[kept].to(r.dtype),
        dw[kept],
        du_sum.to(u.dtype),
        ds,
    )


def _exclusive_cumsum(x: torch.Tensor, dim: int, reverse: bool = False) -> torch.Tensor:
    """Sum over the entries before each (after it, ``reverse``) along ``dim``, the entry
    itself left out (never added and then taken away)."""
    n = x.shape[dim]
    zero = torch.zeros_like(x.narrow(dim, 0, 1))
    if reverse:
        tail = torch.flip(torch.cumsum(torch.flip(x.narrow(dim, 1, n - 1), [dim]), dim), [dim])
        return torch.cat([tail, zero], dim)
    return torch.cat([zero, torch.cumsum(x.narrow(dim, 0, n - 1), dim)], dim)
