"""Serve a decoder LM through the Gateway and its workers: the port's counterpart of
``repro.launch.serve``.

    python -m repro_torch.launch.gateway_serve --arch serpytor-demo-100m \\
        [--transport http|inproc] [--workers 2] [--requests 6] [--new-tokens 8] \\
        [--prompt-len 16] [--seed 0] [--smoke] [--device cpu]

Builds the architecture at its full registered size (``--smoke`` for the
reduced variant), draws params from ``--seed`` and starts ``--workers``
workers that share the one param tree: ``WorkerServer``s (an app port and a
separate heartbeat port each, §3.2) reached through ``WorkerClient``s over
HTTP, or ``InProcWorker``s (``--transport inproc``, the route of
``examples/serve_lm.py``). A ``Gateway`` with context-affinity allocation
routes ``--requests`` seeded prompts to them; each request is one ``generate``
task: a batch-1 prefill and greedy decoding, the reference's loop. Prints
the tokens, wall time, tok/s, the gateway's mean allocation µs and worker
w0's heartbeat, which names the card. The batcher's CLI is
``repro_torch.launch.serve``.
"""

from __future__ import annotations

import argparse
import time
from concurrent.futures import as_completed
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs, smoke_variant
from repro_torch.launch import require_token_inputs
from repro_torch.core import (
    Context,
    Gateway,
    InProcWorker,
    TaskRegistry,
    WorkerClient,
    WorkerServer,
)
from repro_torch.device import resolve_device
from repro_torch.models import build
from repro_torch.optim.adamw import tree_leaves
from repro_torch.params import init_params

__all__ = ["build_registry", "http_workers", "generate_all", "main"]

WORKER_TIMEOUT_S = 300.0  # a WorkerClient's wait for one task's answer
RESULT_TIMEOUT_S = 600.0  # generate_all's wait for every result


@contextmanager
def _on_device(dev: torch.device) -> Iterator[None]:
    """What a task sets on the handler thread that runs it: grad off and, on a card, its
    device current. Both are per thread in PyTorch, and a worker's thread inherits neither
    from the thread that started the worker. The current stream is per thread too; every
    task runs on its thread's default, the device's default stream, which all of them share,
    so their launches stay in order with the allocator's reuse of freed blocks."""
    with torch.no_grad():
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                yield
        else:
            yield


def build_registry(cfg, model, params) -> TaskRegistry:
    """The worker's tasks, as ``repro.launch.serve.build_registry`` defines them: ``generate``
    (batch-1 greedy decoding) and ``health`` (the param tree's MiB). They run on the params'
    device; ``cfg`` is taken for the reference's signature."""
    del cfg
    reg = TaskRegistry()
    dev = tree_leaves(params)[0].device

    @reg.task("generate")
    def generate(ctx, prompt, new_tokens):
        with _on_device(dev):
            toks = torch.as_tensor(np.asarray(prompt, np.int32), dtype=torch.long, device=dev)
            toks = toks[None, :]
            s = toks.shape[1]
            logits, cache = model.prefill(params, {"tokens": toks}, pad_to=s + int(new_tokens))
            tok = torch.argmax(logits, dim=-1)
            out = []
            for _ in range(int(new_tokens)):
                out.append(int(tok[0]))
                logits, cache = model.decode_step(params, cache, {"token": tok})
                tok = torch.argmax(logits, dim=-1)
        return {"tokens": out}

    @reg.task("health")
    def health(ctx):
        return {"params_mb": sum(x.numel() * x.element_size() for x in tree_leaves(params)) / 2**20}

    return reg


@contextmanager
def http_workers(
    registries: Sequence[TaskRegistry],
) -> Iterator[Tuple[List[WorkerServer], List[WorkerClient]]]:
    """Start one ``WorkerServer`` on 127.0.0.1 a registry (w0, w1, ...) and yield the servers
    and their ``WorkerClient``s; every server is stopped on exit."""
    servers: List[WorkerServer] = []
    try:
        for i, reg in enumerate(registries):
            servers.append(WorkerServer(f"w{i}", reg).start())
        clients = [
            WorkerClient(s.name, s.address, s.heartbeat_server.address, timeout=WORKER_TIMEOUT_S)
            for s in servers
        ]
        yield servers, clients
    finally:
        for s in servers:
            s.stop()


def generate_all(
    gw: Gateway, prompts: Sequence[Sequence[int]], new_tokens: int
) -> Tuple[List[Dict[str, Any]], float, List[float]]:
    """Submit one ``generate`` a prompt, all at once (request i: session ``s{i}``, affinity key
    ``s{i % 2}``, as the reference's CLI), and wait for every result. Returns the outputs in
    order, the wall seconds and each request's seconds from its submit to its result. A
    request that failed raises here."""
    futs, submitted = {}, []
    t0 = time.monotonic()
    for i, p in enumerate(prompts):
        fut = gw.submit(
            "generate",
            Context.origin({"session": f"s{i}"}),
            {"prompt": [int(t) for t in p], "new_tokens": int(new_tokens)},
            affinity_key=f"s{i % 2}",
        )
        submitted.append(time.monotonic())
        futs[fut] = i
    outs: List[Optional[Dict[str, Any]]] = [None] * len(prompts)
    latency = [0.0] * len(prompts)
    for fut in as_completed(futs, timeout=RESULT_TIMEOUT_S):
        i = futs[fut]
        latency[i] = time.monotonic() - submitted[i]
        outs[i] = fut.result()
    return outs, time.monotonic() - t0, latency


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="serpytor-demo-100m", choices=list(list_archs()))
    ap.add_argument("--smoke", action="store_true", help="serve the reduced variant")
    ap.add_argument("--transport", choices=("http", "inproc"), default="http")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: cuda (raises without a card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    require_token_inputs(cfg, "repro_torch.launch.gateway_serve")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    model = build(cfg, dev)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(
        f"serving {cfg.name} ({cfg.param_count() / 1e6:.1f}M params) on {args.workers} "
        f"{args.transport} workers ({where})"
    )
    rng = np.random.default_rng(args.seed)
    prompts = [
        rng.integers(0, cfg.vocab_size, args.prompt_len).tolist() for _ in range(args.requests)
    ]
    registries = [build_registry(cfg, model, params) for _ in range(args.workers)]
    with _workers(args.transport, registries) as workers:
        with Gateway(workers, allocation=("context_affinity", "least_loaded")) as gw:
            outs, wall, latency = generate_all(gw, prompts, args.new_tokens)
        hb = workers[0].heartbeat()
    tok = sum(len(o["tokens"]) for o in outs)
    print(
        f"{args.requests} requests / {tok} tokens in {wall:.2f}s ({tok / wall:.1f} tok/s); "
        f"latency {1e3 * sum(latency) / len(latency):.1f} ms mean; "
        f"alloc {gw.mean_alloc_us():.1f}µs"
    )
    print(
        f"worker w0 heartbeat: ok={hb['ok']} cpu={hb['cpu']['used_frac']:.2f} "
        f"devices={hb['devices']}"
    )


@contextmanager
def _workers(transport: str, registries: Sequence[TaskRegistry]) -> Iterator[List[Any]]:
    if transport == "inproc":
        yield [InProcWorker(f"w{i}", reg) for i, reg in enumerate(registries)]
        return
    with http_workers(registries) as (_, clients):
        yield clients


if __name__ == "__main__":
    main()
