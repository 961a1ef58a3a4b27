"""Data-parallel training CLI, the counterpart of ``examples/train_distributed.py``:

    python -m repro_torch.launch.train_distributed --full --shards 4 --workers 2 \\
        --batch 8 --seq 4096 --steps 2 --checkpoint-every 2 --run-dir runs/dist
    python -m repro_torch.launch.train_distributed --device cpu --steps 4 --kill-worker

Each step fans out per-shard gradient tasks over in-process gateway workers,
reduces them in shard order, applies AdamW, and journals everything
(``repro_torch.train.DistributedTrainer``). Kill the process mid-run and
launch it again with the same ``--run-dir`` to watch it resume and verify
every re-executed step against the journal. ``--kill-worker`` makes w0 a
``FlakyWorker`` that dies at its second task start: the gateway requeues its
orphaned shard on the survivors, and the run ends at the same checkpoint
digest as an undisturbed one (compare the printed digest).

Without ``--full`` it trains the example's smoke config (``serpytor-demo-100m``'s
smoke variant, renamed ``serpytor-demo-smoke``; a batch of one sequence of 32
tokens a shard, the example's AdamW); with ``--full`` the published
``serpytor-demo-100m`` (by default two sequences of 4096 tokens a shard, the
train CLI's AdamW). Runs on ``cuda`` unless ``--device cpu``, with
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` unless it is set.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
from typing import List, Optional

from repro_torch.configs import get_config, smoke_variant
from repro_torch.launch import require_token_inputs
from repro_torch.core import FlakyWorker, InProcWorker, Journal
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import DistributedTrainer, DistTrainConfig

from .train import kernel_launches, opt_config

__all__ = ["main"]

ARCH = "serpytor-demo-100m"


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--checkpoint-every", type=int, default=4)
    ap.add_argument("--run-dir", default="")
    ap.add_argument(
        "--kill-worker",
        action="store_true",
        help="crash one worker mid-round (elastic re-shard demo)",
    )
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--full", action="store_true", help="the published config, not the smoke one")
    ap.add_argument("--batch", type=int, default=0, help="global batch (default: 1 or 2 a shard)")
    ap.add_argument("--seq", type=int, default=0, help="tokens a sequence (default: 32 or 4096)")
    args = ap.parse_args(argv)
    # cuBLAS sums in a fixed order only with a fixed workspace, which it reads when its
    # first handle is made; the trainer refuses to run on the card without it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    run_dir = args.run_dir or os.path.join(tempfile.gettempdir(), "serpytor-train-distributed")
    if args.full:
        cfg = get_config(ARCH)
        batch, seq = args.batch or 2 * args.shards, args.seq or 4096
        opt = opt_config(args.steps)
    else:
        cfg = dataclasses.replace(smoke_variant(get_config(ARCH)), name="serpytor-demo-smoke")
        batch, seq = args.batch or args.shards, args.seq or 32
        opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=args.steps)
    require_token_inputs(cfg, "repro_torch.launch.train_distributed")
    tc = DistTrainConfig(
        run_dir=run_dir,
        num_steps=args.steps,
        checkpoint_every=args.checkpoint_every,
        log_every=1,
        global_batch=batch,
        seq_len=seq,
        journal_sync="batch",
        heartbeat=False,
        num_shards=args.shards,
        num_workers=args.workers,
        opt=opt,
    )
    trainer = DistributedTrainer(cfg, tc, device=args.device)
    if args.kill_worker:
        trainer.workers = [
            FlakyWorker("w0", trainer.registry, kill_after_starts=2, max_concurrency=1)
        ] + [
            InProcWorker(f"w{i}", trainer.registry, max_concurrency=1)
            for i in range(1, args.workers)
        ]

    print(
        f"arch={cfg.name} shards={args.shards} workers={args.workers} batch {batch}x{seq} "
        f"run_dir={run_dir} on {args.device}",
        flush=True,
    )
    out = trainer.train()
    digest = trainer.store.manifest(trainer.store.latest())["digest"]
    kinds = Journal(os.path.join(run_dir, "journal.wal"), sync="never").kinds()
    print(
        f"done: {out['steps']} steps in {out['wall_s']:.1f}s, final loss {out['final_loss']:.4f}",
        flush=True,
    )
    print(f"journal kinds: {kinds}", flush=True)
    if kinds.get("NODE_REQUEUE"):
        print(
            f"elastic re-shard: {kinds['NODE_REQUEUE']} orphaned shard task(s) "
            "absorbed by surviving workers",
            flush=True,
        )
    print(f"kernel launches {json.dumps(kernel_launches())}", flush=True)
    print(f"final params digest: {digest}", flush=True)


if __name__ == "__main__":
    main()
