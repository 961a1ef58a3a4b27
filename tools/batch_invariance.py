"""Batch invariance of the PyTorch port's bfloat16 decode, on one NVIDIA card.

    python3 tools/batch_invariance.py

A request decoded alone (batch 1) and the same request with its cache in all
four rows of a batch (the continuous batcher's width) should give the same
logits. ``chip_smoke.py`` holds each served request to its batch-1 run within
a bound; this script looks for where the two part:

1. ops: every bfloat16 product of one layer of the full model (its 2-D
   weights) and the unembed (bfloat16 operands, float32 out, as the port
   computes it), at M = 1 and as row 0 of M = 4; the
   norms in float32 (mean/var and ``torch.mean`` reductions against
   ``F.layer_norm`` and ``F.rms_norm``) at (B, 1, d) and at rwkv6-7b's
   per-head (B, 1, 64, 64). Fresh seeded inputs; a result is the max |diff|
   and the number of elements that differ at all.
2. rwkv6-7b at full width and depth (seeded weights as in ``chip_smoke.py``):
   r0 and r6 of ``chip_smoke.rwkv_prompts``, greedy tokens of the batch-1 run
   fed to the 4-row run, the max |diff| of the logits at every step; once
   with the port's norms (``F.layer_norm``) and once with mean/var norms in
   their place.
3. recurrentgemma-9b at full width and depth: its products as in 2, and the
   other ops of its decode step at batch 1 and as row 0 of batch 4: the
   cached-decode attention, through the kernel (``ops.decode_attention``) and
   through its plain version (batched float32 matmuls and a softmax over a
   bfloat16 ring of one window), the causal conv and the RG-LRU gates
   (``models/rglru.py``); then the same
   drift for r1 and r7 of ``chip_smoke.hybrid_prompts``, with RMSNorm
   through ``F.rms_norm`` (the port's) and through ``torch.mean``.

It only reports; it checks nothing and exits 0 unless a run fails. It needs a
card and a checkout of the repository.
"""

from __future__ import annotations

import sys
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.models import build, layers  # noqa: E402
from repro_torch.models import rglru as rglru_block  # noqa: E402
from repro_torch.params import init_params  # noqa: E402

DEV = cs.DEV
ROWS = cs.SLOTS
MAX_LEN = 3072


def log(msg: str) -> None:
    print(msg, flush=True)


def _diff(one: torch.Tensor, row0: torch.Tensor) -> str:
    d = (one.float() - row0.float()).abs()
    return f"max |diff| {d.max().item():.3e}, {int((d > 0).sum())} of {d.numel()} differ"


def _mean_var_layer_norm(x, shape, weight=None, bias=None, eps=1e-5):
    """LayerNorm through mean/var reductions (the port's form before F.layer_norm)."""
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    out = (x - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def _mean_rmsnorm(x, scale, eps=1e-6):
    """RMSNorm through a ``torch.mean`` reduction (the port's form before F.rms_norm)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


@contextmanager
def _patched(obj, name, fn):
    old = getattr(obj, name)
    setattr(obj, name, fn)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _at_batch_1_and_4(fn, *shape, dtype=torch.float32, seed=0):
    """fn at batch 1 and as row 0 of batch 4, on one seeded input."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    x = torch.randn(ROWS, *shape, generator=gen, device=DEV).to(dtype)
    return fn(x[:1].clone()), fn(x)[:1]


def _each_at_batch_1_and_4(fn, shapes, dtype, seed=0):
    """fn of several seeded inputs, each (4, *shape), at batch 1 and as row 0 of batch 4."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    xs = [torch.randn(ROWS, *shape, generator=gen, device=DEV).to(dtype) for shape in shapes]
    return fn(*(x[:1].clone() for x in xs)), fn(*xs)[:1]


def _layer0(tree, key):
    """The first sub-dict of ``tree`` that holds ``key``, with each leaf at layer 0."""
    if not isinstance(tree, dict):
        return None
    if key in tree:
        return {k: v[0] for k, v in tree.items() if not isinstance(v, dict)}
    for sub in tree.values():
        found = _layer0(sub, key)
        if found is not None:
            return found
    return None


def part_hybrid_decode_ops(params, cfg) -> None:
    """The hybrid's decode-step ops beside its products, at batch 1 and as row 0 of
    batch 4, on seeded inputs of the shapes a decode step gives them."""
    kv, hd, sc = cfg.num_kv_heads, cfg.head_dim, cfg.window
    w = cfg.lru_width

    pos_at = torch.tensor([2250], dtype=torch.int32, device=DEV)  # a ring that has wrapped

    def kernel(q, k_cache, v_cache):
        pos = pos_at.expand(q.shape[0]).contiguous()
        return ops.decode_attention(q, k_cache, v_cache, pos, window=sc)

    def plain(q, k_cache, v_cache):
        pos = pos_at.expand(q.shape[0]).contiguous()
        return ref.decode_attention_ref(q, k_cache, v_cache, pos, window=sc)

    rec = _layer0(params, "conv_w")

    def conv(x, tail):
        return rglru_block._causal_conv1d(x, rec["conv_w"], rec["conv_b"], tail)[0]

    def gates(xi):
        r = torch.sigmoid(layers.dense(xi, rec["w_a"], rec["b_a"]).float())
        i = torch.sigmoid(layers.dense(xi, rec["w_x"], rec["b_x"]).float())
        a = torch.exp(-8.0 * F.softplus(rec["lambda_"].float()) * r)
        return torch.cat([a, i * xi.float()], dim=-1)

    bf16 = torch.bfloat16
    heads = cfg.num_heads
    cases = [
        (f"decode attention kernel q (B,{heads},{hd}) x ring cache (B,{sc},{kv},{hd})", kernel,
         [(heads, hd), (sc, kv, hd), (sc, kv, hd)]),
        ("decode attention plain (ref.decode_attention_ref), same inputs", plain,
         [(heads, hd), (sc, kv, hd), (sc, kv, hd)]),
        (f"causal conv (B,1,{w}) with its tail (B,{cfg.conv1d_width - 1},{w})", conv,
         [(1, w), (cfg.conv1d_width - 1, w)]),
        (f"RG-LRU gates a, i*x on (B,1,{w})", gates, [(1, w)]),
    ]
    for name, fn, shapes in cases:
        one, row0 = _each_at_batch_1_and_4(fn, shapes, bf16)
        log(f"[ops] recurrentgemma-9b {name}, bfloat16 in: {_diff(one, row0)}")


def part_norms(d: int) -> None:
    rms = lambda x: x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-6)  # noqa: E731
    cases = {
        f"layernorm mean/var (B,1,{d})": (lambda x: _mean_var_layer_norm(x, None), (1, d)),
        f"F.layer_norm (B,1,{d})": (lambda x: F.layer_norm(x, (d,)), (1, d)),
        f"rmsnorm torch.mean (B,1,{d})": (rms, (1, d)),
        f"F.rms_norm (B,1,{d})": (lambda x: F.rms_norm(x, (d,), eps=1e-6), (1, d)),
        "group norm mean/var (B,1,64,64)": (lambda x: _mean_var_layer_norm(x, None), (1, 64, 64)),
        "group norm F.layer_norm (B,1,64,64)": (lambda x: F.layer_norm(x, (64,)), (1, 64, 64)),
    }
    for name, (fn, shape) in cases.items():
        one, row0 = _at_batch_1_and_4(fn, *shape)
        log(f"[ops] {name}, float32: {_diff(one, row0)}")


def part_products(tag: str, params, d: int) -> None:
    """Each 2-D weight of the first repeat of segment 0, and the unembed, at M = 1 and
    M = 4."""
    seen = set()

    def visit(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                visit(v, f"{path}/{k}")
            return
        w = tree[0]  # the first layer of the repeat
        if w.dim() != 2 or tuple(w.shape) in seen:
            return
        seen.add(tuple(w.shape))
        one, row0 = _at_batch_1_and_4(lambda x: torch.matmul(x, w), 1, w.shape[0], dtype=w.dtype)
        log(f"[ops] {tag} {w.dtype} x @ {path} {tuple(w.shape)}: {_diff(one, row0)}")

    visit(params["seg0"], "seg0")
    un = params["unembed"] if "unembed" in params else params["embed"]["table"].t()
    one, row0 = _at_batch_1_and_4(
        lambda x: torch.mm(x[:, 0], un, out_dtype=torch.float32), 1, d, dtype=un.dtype
    )
    log(f"[ops] {tag} {un.dtype} unembed {tuple(un.shape)}, float32 out: {_diff(one, row0)}")


def drift(tag: str, model, params, prompt, n: int) -> None:
    """Greedy tokens at batch 1, then the same tokens fed at batch 4: max |diff| of
    the logits at every step (step 0 is the prefill's)."""
    toks, _ = cs._sequential(model, params, prompt, n, MAX_LEN)
    one = cs._teacher_forced(model, params, prompt, toks, rows=1, max_len=MAX_LEN)
    four = cs._teacher_forced(model, params, prompt, toks, rows=ROWS, max_len=MAX_LEN)
    steps = [(a - b).abs().max().item() for a, b in zip(one, four)]
    first = next((i for i, e in enumerate(steps) if e > 1e-4), None)
    log(
        f"[drift] {tag} (prompt {len(prompt)}): max {max(steps):.4e}; first step above 1e-4: "
        f"{first}; per step: {' '.join(f'{e:.1e}' for e in steps)}"
    )


def part_model(name: str, prompts, variants, more_ops=None) -> None:
    cfg = get_config(name)
    params = init_params(cfg, cs._gen(0), DEV)
    model = build(cfg, DEV)
    part_products(name, params, cfg.d_model)
    if more_ops is not None:
        more_ops(params, cfg)
    for label, patch in variants:
        with patch():
            for i in prompts[1]:
                drift(f"{name} r{i}, {label}", model, params, prompts[0][i], cs.NEW_TOKENS)
    del params, model
    cs._release()


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("batch_invariance: torch.cuda.is_available() is False; it needs a card")
    t0 = time.monotonic()
    cs.phase_device()
    _build.build()
    part_norms(4096)

    rwkv = get_config("rwkv6-7b")
    part_model(
        "rwkv6-7b",
        (cs.rwkv_prompts(rwkv.vocab_size), (0, 6)),
        [
            ("F.layer_norm (the port's)", nullcontext),
            ("mean/var norms", lambda: _patched(F, "layer_norm", _mean_var_layer_norm)),
        ],
    )
    hybrid = get_config("recurrentgemma-9b")
    part_model(
        "recurrentgemma-9b",
        (cs.hybrid_prompts(hybrid.vocab_size), (1, 7)),
        [
            ("rmsnorm F.rms_norm (the port's)", nullcontext),
            ("rmsnorm torch.mean", lambda: _patched(layers, "rmsnorm", _mean_rmsnorm)),
        ],
        part_hybrid_decode_ops,
    )
    log(f"[done] {time.monotonic() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
