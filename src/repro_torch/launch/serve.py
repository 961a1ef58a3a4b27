"""Serve a decoder LM through the port's continuous batcher and report its speed.

    python -m repro_torch.launch.serve --arch serpytor-demo-100m --requests 8 \\
        --slots 4 --max-len 1536 [--device cpu]
    python -m repro_torch.launch.serve --arch recurrentgemma-9b --requests 8 \\
        --slots 4 --max-len 3072 --max-prompt 3000
    python -m repro_torch.launch.serve --arch rwkv6-7b --requests 8 \\
        --slots 4 --max-len 3072 --max-prompt 3000
    python -m repro_torch.launch.serve --arch qwen3-1.7b --requests 8 \\
        --slots 4 --max-len 1536
    python -m repro_torch.launch.serve --arch granite-moe-3b-a800m --requests 8 \\
        --slots 4 --max-len 2048 --max-prompt 2000

(``qwen3-1.7b``, ``stablelm-1.6b`` and ``yi-6b`` fit one 80 GB card at full
depth; ``qwen1.5-110b``'s 222.4 GB of bfloat16 weights do not.
``granite-moe-3b-a800m``'s 6.60 GB do: prompts up to 1,024 tokens and every
decode step go through its MoE's dropless sort engine, longer prompts through
its einsum engine, as in the reference without a mesh.)

Builds the architecture at its full registered size (``--smoke`` for the
reduced variant), draws params from ``--seed``, submits ``--requests``
prompts of seeded random lengths and drains the batcher. Prints tok/s, the
mean prefill time and the decode time per step. The Gateway / HTTP worker
route of ``repro.launch.serve`` is ``repro_torch.launch.gateway_serve``.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs, smoke_variant
from repro_torch.device import resolve_device
from repro_torch.models import build
from repro_torch.params import init_params
from repro_torch.serve import ContinuousBatcher, Generation, Request

__all__ = ["make_prompts", "serve", "drain", "main"]


def make_prompts(n: int, vocab: int, min_len: int, max_len: int, seed: int) -> List[np.ndarray]:
    """``n`` prompts with lengths drawn uniformly in [min_len, max_len]."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(min_len, max_len + 1, size=n)
    return [rng.integers(0, vocab, size=int(s)).astype(np.int32) for s in lens]


def serve(
    model, params, prompts: List[np.ndarray], *, new_tokens: int, slots: int, max_len: int
) -> Dict[str, object]:
    """Drain ``prompts`` through a fresh batcher; returns generations and timings."""
    eng = ContinuousBatcher(model, params, slots=slots, max_len=max_len)
    return drain(eng, prompts, new_tokens=new_tokens)


def drain(
    eng: ContinuousBatcher, prompts: List[np.ndarray], *, new_tokens: int
) -> Dict[str, object]:
    """Submit ``prompts`` as requests r0, r1, ... to ``eng`` and run it until
    drained; returns generations and timings."""
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=f"r{i}", prompt=p, max_new_tokens=new_tokens))
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    t0 = time.monotonic()
    done: Dict[str, Generation] = eng.run_until_drained()
    wall = time.monotonic() - t0
    n_tok = sum(len(g.tokens) for g in done.values())
    prefill_s = sum(g.prefill_s for g in done.values())
    return {
        "generations": done,
        "wall_s": wall,
        "tokens": n_tok,
        "tok_per_s": n_tok / wall,
        "prefill_ms_mean": 1e3 * prefill_s / len(done),
        # every step after admission is one decode step over all slots
        "decode_ms_per_step": 1e3 * (wall - prefill_s) / max(eng.steps, 1),
        "steps": eng.steps,
        "utilization": eng.utilization(),
    }


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="serpytor-demo-100m", choices=list(list_archs()))
    ap.add_argument("--smoke", action="store_true", help="serve the reduced variant")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=1536)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--min-prompt", type=int, default=64)
    ap.add_argument("--max-prompt", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: cuda (raises without a card)")
    args = ap.parse_args(argv)
    if args.max_prompt >= args.max_len:
        ap.error(f"--max-prompt {args.max_prompt} must be below --max-len {args.max_len}")

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen, dev)
    model = build(cfg, dev)
    prompts = make_prompts(
        args.requests, cfg.vocab_size, args.min_prompt, args.max_prompt, args.seed
    )
    res = serve(
        model, params, prompts, new_tokens=args.new_tokens, slots=args.slots, max_len=args.max_len
    )
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(
        f"{cfg.name} on {where}: {args.requests} requests, {res['tokens']} tokens in "
        f"{res['wall_s']:.3f}s -> {res['tok_per_s']:.1f} tok/s; prefill "
        f"{res['prefill_ms_mean']:.2f} ms mean; decode {res['decode_ms_per_step']:.2f} ms/step "
        f"over {res['steps']} steps (slot utilization {res['utilization']:.2f})"
    )


if __name__ == "__main__":
    main()
