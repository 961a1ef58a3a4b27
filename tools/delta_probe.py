"""Where seamless-m4t-large-v2's bfloat16 gradient leaves the plain path, on one NVIDIA card.

    python3 tools/delta_probe.py

seamless-m4t-large-v2 at full size in bfloat16 (remat "full", params from ``_gen(0)``, one
sequence of 4,096 frames and 4,096 tokens) takes its step-0 gradient through several
attention backwards, each put in place of ``FlashAttentionFunction.backward`` (the forward
stays the kernel's, which saves its output in float32), each with D = rowsum(dO o O) from
that float32 output ("f32 O") or from the output rounded to bfloat16 ("bf16 O", as the
kernels took it before the float32 output was saved):

- ``kernel``: the port's bfloat16 backward kernels;
- ``plain``: the plain backward (``ref.flash_attention_bwd_ref``, float32 P and dS);
- ``rounded``: a dense float32 model of the kernels' arithmetic (P and dS rounded to
  bfloat16 where they enter dV, dQ and dK).

Each gradient is held against the plain path's (``attn_impl="ref"``: plain attention under
autograd, bfloat16) by relative L2 norm a leaf, over the plain path's own gap to a float32
run: the ratio chip_smoke.py's train gates hold within 4. Prints each variant's largest
ratios and the decoder's ``ln_x`` bias. About two minutes of command; it needs a card.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)

import torch  # noqa: E402

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402


def _rounded(q, k, v, out, lse, dout, causal, window, scale):
    """The kernels' arithmetic as a dense float32 model: products of bfloat16 operands summed in
    float32, P rounded to bfloat16 for dV, dS for dQ and dK, D from ``out`` as given; dQ less
    each row's sum of its bfloat16 dS times the mean of the first 64 keys (the dQ kernel's
    kbar where no window cuts the walk's start)."""
    g = q.shape[1] // k.shape[1]
    d = q.shape[-1]
    scale = d**-0.5 if scale is None else scale
    qf, kf, vf, dof = (x.float() for x in (q, k, v, dout))
    kx, vx = kf.repeat_interleave(g, dim=1), vf.repeat_interleave(g, dim=1)
    sq, sk = q.shape[2], k.shape[2]
    valid = ref._mask(sq, torch.arange(sk, device=q.device), sk, causal, window)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kx) * scale
    p = torch.where(valid, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    del s
    delta = (dof * out.float()).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vx) - delta)
    pr, dsr = p.bfloat16().float(), ds.bfloat16().float()
    del p, ds
    b, hkv = k.shape[:2]
    kbar = kx[:, :, :64].mean(2, keepdim=True)
    dq = (torch.einsum("bhqk,bhkd->bhqd", dsr, kx) - dsr.sum(-1, keepdim=True) * kbar) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", dsr, qf).reshape(b, hkv, g, sk, d).sum(2) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", pr, dof).reshape(b, hkv, g, sk, -1).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


def _variant(name):
    """A backward for ``FlashAttentionFunction`` that computes ``name``'s gradients."""

    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale = ctx.masks
        dout = dout.contiguous()
        masks = dict(causal=causal, window=window, scale=scale)
        if "bf16 O" in name:
            out = out.to(q.dtype)
        if name.startswith("kernel"):
            grads = fa.flash_attention_bwd(q, k, v, out, lse, dout, **masks)
        elif name.startswith("plain"):
            grads = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **masks)
        else:
            grads = _rounded(q, k, v, out, lse, dout, causal, window, scale)
        return (*grads, None, None, None)

    return staticmethod(backward)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("delta_probe: this run needs a card")
    print(cs.phase_device(), flush=True)
    cfg = cs.get_config(cs.SEAMLESS_ARCH)
    gen = cs._gen(13)
    frames = torch.randn(1, cs.TRAIN_SEQ, cfg.frontend_dim, generator=gen, device=cs.DEV)
    data = cs.DataConfig(vocab_size=cfg.vocab_size, seq_len=cs.TRAIN_SEQ, global_batch=1, seed=0)
    tokens = torch.from_numpy(cs.TokenSource(data).batch_at(0)["tokens"]).long().to(cs.DEV)
    batch = {"tokens": tokens, "frames": frames.to(torch.bfloat16)}
    params = cs.init_params(cfg, cs._gen(0), cs.DEV)
    plain = cs.build(dataclasses.replace(cfg, attn_impl="ref"), cs.DEV)
    _, plain_grads = cs._grad_run(plain, params, batch)
    cfg32 = dataclasses.replace(
        cfg, attn_impl="ref", param_dtype="float32", compute_dtype="float32"
    )
    params32 = cs.tree_map(lambda x: x.float(), params)
    _, grads32 = cs._grad_run(cs.build(cfg32, cs.DEV), params32, batch)
    del params32
    cs._release()
    names = [n for n, _ in cs._named_leaves(plain_grads)]
    gap = {
        n: _rel_l2(p, w)
        for n, p, w in zip(names, cs.tree_leaves(plain_grads), cs.tree_leaves(grads32))
    }
    del grads32
    model = cs.build(cfg, cs.DEV)
    cls = fa.FlashAttentionFunction
    kept = cls.backward
    variants = [f"{way}, {o} O" for way in ("kernel", "plain", "rounded") for o in ("f32", "bf16")]
    try:
        for name in variants:
            cls.backward = _variant(name)
            _, grads = cs._grad_run(model, params, batch)
            ratio = {
                n: _rel_l2(g, p) / max(gap[n], 1e-30)
                for n, g, p in zip(names, cs.tree_leaves(grads), cs.tree_leaves(plain_grads))
            }
            worst = sorted(ratio.items(), key=lambda kv: -kv[1])[:5]
            ln_x = {n: f"{r:.3f}" for n, r in ratio.items() if "ln_x/bias" in n}
            print(
                f"[delta probe] {name}: the largest diff/gap "
                + ", ".join(f"{n} {r:.3f}" for n, r in worst)
                + f"; ln_x bias {ln_x} (its gap {[f'{gap[n]:.3e}' for n in ln_x]})",
                flush=True,
            )
            del grads
            cs._release()
    finally:
        cls.backward = kept
    return 0


if __name__ == "__main__":
    sys.exit(main())
