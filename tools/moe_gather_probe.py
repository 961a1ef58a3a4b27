"""The MoE layer's backward at granite-moe-3b-a800m's train shape, with the gathers'
gradients as gathers by inverse tables and with ``index_select``'s backward in their place.

    python3 tools/moe_gather_probe.py

One full-width MoE block of granite-moe-3b-a800m (d 1536, 40 experts, top 8, moe_d_ff 512)
in bfloat16 on 1 x 4096 tokens, as its train step runs it: the einsum engine (16 groups of
256 tokens, capacity 64, drops), under ``torch.use_deterministic_algorithms(True)``. Two
variants of ``models/moe.py``'s three gathers (the dispatch, the combine, the router
weights' permutation): the port's ``_GatherRows`` (the gradient a gather by the inverse
table, float32 sums in ascending expert id, rounded once) and a plain ``index_select`` under
autograd (its gradient ``index_add``, whose deterministic path sorts the indices). In turns
(port, index_select, index_select, port): the forward's and the backward's device ms (CUDA
events around each, over 10 runs after 2 warm ones), then each variant's backward under
torch.profiler (its kernels by device time); then the gradients of x and of every param of
the two variants compared (elements that differ, the largest difference) and the port's
twice (equal bits). About a minute of command; it needs a card, and fails without one.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from pathlib import Path

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # before torch's first handle

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402
from repro_torch.params import init_params  # noqa: E402

TOKENS, RUNS, WARM = 4096, 10, 2
PORT_GATHER = moe_mod._GatherRows.apply


def _plain_gather(x, table, inv):
    """The same rows under autograd: ``index_select``'s gradient adds by ``index_add``."""
    return moe_mod._rows(x, table)


def _step(x, p, g, cfg):
    """One forward and backward of the block: (forward ms, backward ms, grads of x and p)."""
    x = x.detach().requires_grad_(True)
    p = tree_map(lambda t: t.detach().requires_grad_(True), p)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    out, _ = moe_mod.moe_block(x, p, cfg, with_aux=False)
    ev[1].record()
    ev[2].record()
    out.backward(g)
    ev[3].record()
    torch.cuda.synchronize()
    grads = [x.grad] + [t.grad for t in tree_leaves(p)]
    return ev[0].elapsed_time(ev[1]), ev[2].elapsed_time(ev[3]), grads


def _timed(name, gather, x, p, g, cfg):
    moe_mod._GatherRows.apply = gather
    try:
        for _ in range(WARM):
            _step(x, p, g, cfg)
        fwd, bwd = zip(*(_step(x, p, g, cfg)[:2] for _ in range(RUNS)))
    finally:
        moe_mod._GatherRows.apply = PORT_GATHER
    cs.log(
        f"[moe gather probe] {name}: forward {sum(fwd) / RUNS:.4f} ms, backward "
        f"{sum(bwd) / RUNS:.4f} ms (device, CUDA events, mean of {RUNS}; min "
        f"{min(bwd):.4f}, max {max(bwd):.4f})"
    )
    return sum(bwd) / RUNS


def _profiled(name, gather, x, p, g, cfg):
    moe_mod._GatherRows.apply = gather
    try:
        x = x.detach().requires_grad_(True)
        p = tree_map(lambda t: t.detach().requires_grad_(True), p)
        out, _ = moe_mod.moe_block(x, p, cfg, with_aux=False)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            out.backward(g)
            torch.cuda.synchronize()
    finally:
        moe_mod._GatherRows.apply = PORT_GATHER
    rows = cs._device_rows(prof)
    if not rows:
        cs.log(f"[moe gather probe] {name} backward profile: no device time recorded")
        return
    total = sum(us for us, _, _ in rows)
    top = "; ".join(f"{k[:60]} {us:.1f} us x{n}" for us, n, k in rows[:10])
    cs.log(
        f"[moe gather probe] {name} backward profiled: device {total:.1f} us in "
        f"{sum(n for _, n, _ in rows)} kernels; by device time: {top}"
    )


def _compare(a, b, what):
    differ = sum(int((x != y).sum()) for x, y in zip(a, b))
    worst = max(
        ((x.float() - y.float()).abs().max() / y.float().abs().max().clamp_min(1e-30)).item()
        for x, y in zip(a, b)
    )
    n = sum(x.numel() for x in a)
    cs.log(
        f"[moe gather probe] gradients {what}: {differ} of {n} elements differ; the largest "
        f"difference {worst:.3e} of its leaf's largest entry"
    )
    return differ


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("moe_gather_probe: torch.cuda.is_available() is False")
    smi = cs.phase_device()
    torch.use_deterministic_algorithms(True)
    cfg = dataclasses.replace(get_config(cs.MOE_ARCH), num_layers=1)
    p = cs._index(init_params(cfg, cs._gen(0), "cuda")["seg0"]["u0"]["moe"], 0)  # layer 0
    gen = cs._gen(1)
    x = torch.randn(1, TOKENS, cfg.d_model, generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn(1, TOKENS, cfg.d_model, generator=gen, device="cuda").to(torch.bfloat16)
    G = TOKENS // cfg.moe_group_size
    cap = int(cfg.moe_group_size * cfg.num_experts_per_tok / cfg.num_experts * 1.25)
    cs.log(
        f"[moe gather probe] {cfg.name} MoE block, bfloat16, 1 x {TOKENS} tokens: einsum engine, "
        f"{G} groups of {cfg.moe_group_size}, capacity {cap}; {smi}"
    )
    times = {"port": [], "index_select": []}
    for name in ("port", "index_select", "index_select", "port"):
        gather = PORT_GATHER if name == "port" else _plain_gather
        times[name].append(_timed(name, gather, x, p, g, cfg))
    for name, gather in (("port", PORT_GATHER), ("index_select", _plain_gather)):
        _profiled(name, gather, x, p, g, cfg)
    port = _step(x, p, g, cfg)[2]
    again = _step(x, p, g, cfg)[2]
    moe_mod._GatherRows.apply = _plain_gather
    try:
        plain = _step(x, p, g, cfg)[2]
    finally:
        moe_mod._GatherRows.apply = PORT_GATHER
    if _compare(port, again, "of the port's two runs"):
        raise AssertionError("[moe gather probe] the port's gradients differ between two runs")
    _compare(port, plain, "port against index_select")
    cs.log(
        "[moe gather probe] backward ms, port "
        + ", ".join(f"{t:.4f}" for t in times["port"])
        + "; index_select "
        + ", ".join(f"{t:.4f}" for t in times["index_select"])
        + f" ({smi})"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
