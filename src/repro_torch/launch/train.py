"""Training CLI, the counterpart of ``python -m repro.launch.train``:

    python -m repro_torch.launch.train --arch serpytor-demo-100m --full --batch 4 \\
        --seq 4096 --steps 3 --checkpoint-every 2 --run-dir runs/demo
    python -m repro_torch.launch.train --arch serpytor-demo-100m --device cpu --steps 2

Selects an architecture config (``--reduced``, the default, takes its smoke
variant; ``--full`` the published one; ``--layers N`` keeps its first N
layers) and runs the durable ``Trainer``:
journaled rounds, checkpoints, a heartbeat, replay verification. Run the
same command again on the same ``--run-dir`` and it recovers from the newest
complete checkpoint and re-executes, and verifies against the journal, every
step after it. Runs on ``cuda`` unless ``--device cpu``, with
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` unless it is set. The dense, hybrid
and RWKV6 families train; the others raise where train mode refuses them
(ROADMAP Queue 1 items 8–10). Their published configs (``--full``) are
bfloat16 and train durably too: params and AdamW state cross the host
boundary by their bits (``train/host.py``), and their checkpoints digest as
the reference's do, e.g.

    python -m repro_torch.launch.train --arch qwen3-1.7b --full --layers 2 --batch 2 \\
        --seq 4096 --steps 3 --checkpoint-every 2 --run-dir runs/qwen3

Prints the heartbeat's address, a line per ``--log-every`` steps (as the
reference), and at the end the summary and the launches of every kernel a train
step can run (:func:`kernel_launches`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import List, Optional

from repro_torch.configs import SHAPES, get_config, list_archs, smoke_variant
from repro_torch.launch import require_token_inputs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rglru as rg
from repro_torch.kernels import wkv6 as wk
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import TrainConfig, Trainer

__all__ = ["kernel_launches", "main", "opt_config"]


def opt_config(steps: int) -> AdamWConfig:
    """The AdamW this CLI trains with for ``steps`` steps (the reference CLI's)."""
    return AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=steps)



def kernel_launches() -> dict:
    """The launch counts of every kernel a train step can run, in this process."""
    return {
        "flash_attention_fwd": fa.flash_attention_fwd.launches,
        "flash_attention_bwd": fa.flash_attention_bwd.launches,
        "rglru_scan": rg.rglru_scan.launches,
        "rglru_bwd": rg.rglru_bwd.launches,
        "wkv6_chunked": wk.wkv6_chunked.launches,
        "wkv6_bwd": wk.wkv6_bwd.launches,
    }

def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(list_archs()))
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--run-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument(
        "--reduced",
        action="store_true",
        default=True,
        help="use the reduced same-family config (the default)",
    )
    ap.add_argument(
        "--full", dest="reduced", action="store_false", help="use the full published config"
    )
    ap.add_argument(
        "--layers", type=int, default=0, help="train the config's first N layers (0: all)"
    )
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--journal-sync", default="batch", choices=["always", "batch", "never"])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    # cuBLAS sums in a fixed order only with a fixed workspace, which it reads when its
    # first handle is made (nothing has touched the card yet); the trainer refuses to
    # run on the card without it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    cfg = get_config(args.arch)
    require_token_inputs(cfg, "repro_torch.launch.train")
    shape = SHAPES[args.shape]
    if args.reduced:
        cfg = smoke_variant(cfg)
        batch = args.batch or 2
        seq = args.seq or 64
    else:
        batch = args.batch or shape.global_batch
        seq = args.seq or shape.seq_len
    if args.layers:
        if not 1 <= args.layers <= cfg.num_layers:
            ap.error(f"--layers {args.layers}: {cfg.name} has {cfg.num_layers} layers")
        cfg = dataclasses.replace(
            cfg, num_layers=args.layers, block_pattern=cfg.block_pattern[: args.layers]
        )

    run_dir = args.run_dir or f"runs/{cfg.name}"
    print(
        f"training {cfg.name}: {cfg.num_layers} layers, {cfg.param_count() / 1e6:.1f}M params, "
        f"{args.steps} steps, batch {batch}×{seq} → {run_dir} on {args.device}",
        flush=True,
    )
    tc = TrainConfig(
        run_dir=run_dir,
        num_steps=args.steps,
        checkpoint_every=args.checkpoint_every,
        global_batch=batch,
        seq_len=seq,
        journal_sync=args.journal_sync,
        opt=opt_config(args.steps),
    )
    trainer = Trainer(cfg, tc, device=args.device)
    if trainer.heartbeat is not None:
        print(f"heartbeat at {trainer.heartbeat.address}", flush=True)
    out = trainer.train()
    print(
        f"done: {out['steps']} steps, {out['steps_per_s']:.2f} steps/s, "
        f"final loss {out['final_loss']}",
        flush=True,
    )
    print(f"kernel launches {json.dumps(kernel_launches())}", flush=True)


if __name__ == "__main__":
    main()
