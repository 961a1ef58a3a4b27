"""Trainer: the training loop AS a SerPyTor durable context-graph, the counterpart of
``repro.train.trainer``.

Every training round (K steps + checkpoint) is a ContextGraph of atomic
tasks — ``data@s`` → ``step@s`` → ``ckpt@e`` — run by the port's
``LocalExecutor``. The run context ξ carries (run_id, config digest, mesh,
data seed); every node commit lands in the journal. The graph, the node ids,
their data and the journal records are the reference's, so on the same
params and data the port's journal holds the reference's context and input
digests (``tests/test_torch_trainer.py``).

Durability semantics (event sourcing + snapshots, §4.2):
  - the journal is the event history; the CheckpointStore holds snapshots,
    referenced from CKPT records (never tensors in the journal);
  - recovery = restore latest snapshot, then RE-EXECUTE the steps after it:
    deterministic data (batch = f(seed, step)), a seeded init and
    deterministic kernels make re-execution bit-identical, and committed
    step records let the trainer VERIFY that (digest equality);
  - a replayed step whose digest disagrees with the journal is a hard
    error, and it leaves the restored state untouched.

On the card every step runs the flash forward and backward kernels; the
trainer runs under ``torch.use_deterministic_algorithms(True)`` and needs
``CUBLAS_WORKSPACE_CONFIG`` set before the first cuBLAS handle (the CLI,
``repro_torch.launch.train``, sets it), since a replay cannot be verified
without fixed sums. Steps run on the executor's pool threads, each on the
default stream.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, Tuple

import torch

from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs.base import ModelConfig
from repro_torch.core import (
    Context,
    ContextGraph,
    HeartbeatServer,
    Journal,
    JournalRecord,
    LocalExecutor,
    StragglerWatch,
    WithContext,
)
from repro_torch.data.pipeline import DataConfig, TokenSource
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import build
from repro_torch.obs.metrics import metrics as obs_metrics
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.params import from_numpy_opt_state, from_numpy_tree, init_params
from repro_torch.wire import canonical_digest, payload_digest

from .host import to_host
from .steps import make_donating_train_step, make_train_step

__all__ = ["TrainConfig", "Trainer", "restore_pair"]


@dataclass
class TrainConfig:
    run_dir: str
    num_steps: int = 100
    checkpoint_every: int = 25
    log_every: int = 10
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 256
    journal_sync: str = "batch"  # always (paper-strict) | batch | never
    async_checkpoint: bool = True
    heartbeat: bool = True
    mesh_model_axis: int = 1
    opt: AdamWConfig = field(default_factory=AdamWConfig)


def restore_pair(
    store: CheckpointStore, tag: str, cfg: ModelConfig, opt: AdamWConfig, device: torch.device
) -> Tuple[int, Any, Any]:
    """(next_step, params, opt_state) of the checkpoint pair ``tag`` and ``tag-opt``.

    Both shards restore through the digest-verified ``resolve()`` path, onto
    ``device``: on-disk corruption or tampering that preserves shapes raises.
    The trees a restore is shaped by come from the config on the ``meta``
    device; nothing is drawn. bfloat16 leaves come back by their bits.
    """
    man = store.manifest(tag)
    like_p = init_params(cfg, None, "meta")
    params = store.resolve(f"{tag}@{man['digest']}", like_p)
    params = from_numpy_tree(params, device)
    man_o = store.manifest(tag + "-opt")
    opt_state = store.resolve(f"{tag}-opt@{man_o['digest']}", adamw_init(like_p, opt))
    opt_state = from_numpy_opt_state(opt_state, device)
    return int(man["meta"]["next_step"]), params, opt_state


class Trainer:
    #: node-id prefix of the per-step metric commits this trainer journals;
    #: the replay-digest scan and the metrics collector both key off it
    step_node_prefix = "step@"

    def __init__(self, cfg: ModelConfig, tc: TrainConfig, device: DeviceLike = None):
        self.device = resolve_device(device)
        if tc.mesh_model_axis != 1:
            raise NotImplementedError(
                f"mesh_model_axis={tc.mesh_model_axis}: the port trains on one device; "
                "a model axis waits for ROADMAP Queue 1 item 11"
            )
        if self.device.type == "cuda" and not os.environ.get("CUBLAS_WORKSPACE_CONFIG"):
            raise RuntimeError(
                "Trainer on cuda needs CUBLAS_WORKSPACE_CONFIG (e.g. :4096:8) set before the "
                "first cuBLAS handle: without it cuBLAS sums in no fixed order and a replayed "
                "step cannot be verified against the journal"
            )
        self.cfg = cfg
        self.tc = tc
        os.makedirs(tc.run_dir, exist_ok=True)
        self.model = build(cfg, self.device)
        self.store = CheckpointStore(os.path.join(tc.run_dir, "ckpt"))
        self.journal = Journal(os.path.join(tc.run_dir, "journal.wal"), sync=tc.journal_sync)
        self.heartbeat = HeartbeatServer(extra={"worker": "trainer"}) if tc.heartbeat else None
        self.stragglers = StragglerWatch()
        self.data_cfg = DataConfig(
            vocab_size=cfg.vocab_size,
            seq_len=tc.seq_len,
            global_batch=tc.global_batch,
            seed=tc.seed,
        )
        self.source = TokenSource(self.data_cfg)
        # The fresh-execution step updates params/opt in place (the
        # reference's donated buffers). The VERIFY twin is out of place: a
        # replayed step must be able to fail its digest check and leave the
        # restored state untouched — the in-place step would have overwritten it.
        self._train_step = make_donating_train_step(self.model, tc.opt)
        self._train_step_verify = make_train_step(self.model, tc.opt)
        # steps whose state buffers were updated in place this incarnation: a
        # second execution would start from the wrong state, so it is refused
        self._donated_steps: set = set()
        self.metrics_log: list = []
        self.restore_s: float = 0.0  # seconds of the last restore (0.0: fresh init)

    # -- run identity --------------------------------------------------------
    def run_context(self) -> Context:
        return Context.origin(
            {
                "run_id": canonical_digest({"cfg": self.cfg.name, "seed": self.tc.seed}),
                "config_digest": canonical_digest(repr(self.cfg)),
                "mesh": {"data": 1, "model": 1},  # one device, as the reference's mesh names it
                "data_seed": self.tc.seed,
            },
            origin="trainer",
        )

    # -- recovery ------------------------------------------------------------
    def recover(self) -> Tuple[int, Any, Any]:
        """(start_step, params, opt_state) — from snapshot or fresh init.

        Only *complete* checkpoint pairs count: the params save is sync but
        the ``-opt`` companion may be async, so a crash can publish the base
        tag without its optimizer shard. Recovery falls back to the newest
        pair whose companion exists instead of failing on the missing shard.

        Both shards restore through :func:`restore_pair`: the digest-verified
        ``resolve()`` path, onto ``self.device``.
        """
        tag = self.store.latest(companions=("-opt",))
        if tag is not None:
            t0 = time.monotonic()
            start, params, opt_state = restore_pair(
                self.store, tag, self.cfg, self.tc.opt, self.device
            )
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.restore_s = time.monotonic() - t0
            return start, params, opt_state
        gen = torch.Generator(device=self.device).manual_seed(self.tc.seed)
        params = init_params(self.cfg, gen, self.device)
        opt_state = adamw_init(params, self.tc.opt)
        return 0, params, opt_state

    # -- one durable round (K steps + checkpoint) ------------------------------
    def _round_graph(
        self,
        start: int,
        end: int,
        state: Dict[str, Any],
        replay_digests: Dict[int, str],
        incarnation: int = 0,
    ) -> ContextGraph:
        """Step nodes are STATEFUL (they advance params held by reference),
        so they must never be replay-SKIPPED across process incarnations —
        the state side effect would be lost. Their Ψ therefore carries the
        incarnation nonce: recovery re-executes them from the restored
        snapshot and VERIFIES the journal digests instead (event sourcing
        with snapshots). Pure nodes (data fetch) replay normally."""
        g = ContextGraph(origin=self.run_context(), name=f"round{start}")
        prev = None
        for s in range(start, end):
            fetch_id, step_id = f"data@{s}", f"step@{s}"

            def fetch(ctx, _s=s):
                self.stragglers.started("data_fetch", _s)
                batch = self.source.batch_at(_s)
                self.stragglers.finished("data_fetch", _s)
                return {"step": _s, "digest": payload_digest(batch)}

            g.add(fetch_id, fetch, data={"step": s})

            def run_step(ctx, _s=s, _fid=fetch_id, **deps):
                meta = deps[_fid]
                batch = self.source.batch_at(_s)  # DI: regenerate (pure fn)
                tbatch = {k: torch.from_numpy(v).long().to(self.device) for k, v in batch.items()}
                want = replay_digests.get(_s)
                if _s in self._donated_steps:
                    # the in-place step already overwrote this state's
                    # buffers; a re-execution would start from the wrong
                    # state. This is unreachable via the executor (step
                    # nodes carry retries=0) and exists to make the hazard
                    # loud if a caller re-runs a round graph by hand.
                    raise RuntimeError(
                        f"step {_s} already donated its input buffers; "
                        "re-executing it is unsafe (restore a snapshot and "
                        "build a fresh round graph instead)"
                    )
                if want is None:
                    # fresh execution: updating in place is safe — nothing
                    # can demand the pre-step state after this commit
                    self._donated_steps.add(_s)
                    step_fn = self._train_step
                else:
                    # replay-verification: run the out-of-place twin so a
                    # digest mismatch leaves the restored state intact
                    step_fn = self._train_step_verify
                new_params, new_opt, metrics = step_fn(state["params"], state["opt"], tbatch)
                out = {k: float(v) for k, v in metrics.items()}
                out["step"] = _s
                out["data_digest"] = meta["digest"]
                got = payload_digest(out)
                if want is not None and want != got:
                    raise RuntimeError(
                        f"non-deterministic replay at step {_s}: journal={want} recomputed={got}"
                    )
                # verified (or fresh): only now does the mutation commit
                state["params"], state["opt"] = new_params, new_opt
                return out

            deps = [fetch_id] + ([prev] if prev else [])
            g.add(step_id, run_step, deps=deps, data={"incarnation": incarnation}, retries=0)
            prev = step_id

        self._add_checkpoint_node(g, state, prev, end)
        return g

    def _add_checkpoint_node(
        self, g: ContextGraph, state: Dict[str, Any], prev: str, end: int
    ) -> None:
        """Append the round-closing checkpoint node (snapshot + CKPT record).

        The params save is synchronous; the ``-opt`` companion may be async
        (off the critical path). Recovery tolerates a torn pair — see
        :meth:`recover`.
        """

        def checkpoint(ctx, **deps):
            last = deps[prev]
            next_step = last["step"] + 1
            tag = f"step{next_step:08d}"
            ref_p = self.store.save(
                tag, to_host(state["params"]), {"next_step": next_step}, async_=False
            )
            ref_o = self.store.save(
                tag + "-opt",
                to_host(state["opt"]),
                {"next_step": next_step},
                async_=self.tc.async_checkpoint,
            )
            self.journal.append(
                JournalRecord(
                    kind="CKPT", node_id=tag, ref=f"{ref_p};{ref_o}", meta={"next_step": next_step}
                )
            )
            return WithContext({"ref": ref_p, "next_step": next_step}, {"last_ckpt": ref_p})

        g.add(f"ckpt@{end}", checkpoint, deps=[prev])

    # -- shared machinery ----------------------------------------------------------
    def _scan_journal(self) -> Tuple[Dict[int, str], int]:
        """(replay_digests, incarnation) from previous runs of this journal.

        ``replay_digests[step]`` is the metric-payload digest a previous
        incarnation committed for that step: the determinism oracle the
        re-executed step must match. The incarnation count salts stateful
        nodes' Ψ so they re-execute instead of replay-skipping.
        """
        replay_digests: Dict[int, str] = {}
        incarnation = 0
        if os.path.exists(self.journal.path):
            prefix = self.step_node_prefix
            for rec in self.journal.records():
                if rec.kind == "RUN_START":
                    incarnation += 1
                if rec.kind == "NODE_COMMIT" and rec.node_id.startswith(prefix):
                    if isinstance(rec.payload, dict) and "step" in rec.payload:
                        replay_digests[int(rec.payload["step"])] = rec.output_digest
        return replay_digests, incarnation

    @contextlib.contextmanager
    def _executor_scope(self) -> Iterator[Any]:
        """Yield the executor this trainer runs rounds on (local here)."""
        yield LocalExecutor(max_workers=4, journal=self.journal)

    def _collect_metrics(self, report) -> None:
        """Pull this round's step metrics out of a report, in step order.

        Besides the local ``metrics_log`` (summary.json), each round also
        feeds the process-global :mod:`repro_torch.obs.metrics` registry.
        """
        metrics = [
            report.outputs[n] for n in report.outputs if n.startswith(self.step_node_prefix)
        ]
        for m in sorted(metrics, key=lambda r: r["step"]):
            self.metrics_log.append(m)
            if m["step"] % self.tc.log_every == 0:
                print(
                    f"step {m['step']:5d} loss {m['loss']:.4f} "
                    f"gnorm {m['grad_norm']:.3f} "
                    f"lr {m['lr']:.2e}",
                    flush=True,
                )
        if metrics:
            reg = obs_metrics()
            reg.counter("repro_train_steps_total").inc(len(metrics))
            last = max(metrics, key=lambda m: m["step"])
            reg.gauge("repro_train_step").set(float(last["step"]))
            reg.gauge("repro_train_loss").set(float(last["loss"]))
            reg.gauge("repro_train_grad_norm").set(float(last["grad_norm"]))
            reg.gauge("repro_train_lr").set(float(last["lr"]))

    # -- main loop ----------------------------------------------------------------
    def train(self) -> Dict[str, Any]:
        """Run rounds up to ``num_steps``, recovering first; writes ``summary.json``.

        ``summary.json`` holds the reference's keys, plus ``restore_s`` and
        ``checkpoint_s`` (each save's seconds, by tag).
        """
        if self.heartbeat:
            self.heartbeat.start()
        t0 = time.monotonic()  # wall_s is a duration: clock steps must not skew it
        # replay digests from previous incarnations (determinism check) +
        # incarnation nonce (see _round_graph docstring)
        replay_digests, incarnation = self._scan_journal()
        deterministic = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            start, params, opt_state = self.recover()
            state = {"params": params, "opt": opt_state}
            with self._executor_scope() as executor:
                s = start
                while s < self.tc.num_steps:
                    e = min(s + self.tc.checkpoint_every, self.tc.num_steps)
                    graph = self._round_graph(s, e, state, replay_digests, incarnation=incarnation)
                    report = executor.run(graph)
                    self._collect_metrics(report)
                    s = e
        finally:
            torch.use_deterministic_algorithms(deterministic)
            self.store.wait()
            self.journal.flush()
            if self.heartbeat:
                self.heartbeat.stop()
        wall = time.monotonic() - t0
        out = {
            "steps": self.tc.num_steps - start,
            "wall_s": wall,
            "final_loss": self.metrics_log[-1]["loss"] if self.metrics_log else None,
            "steps_per_s": (self.tc.num_steps - start) / max(wall, 1e-9),
            "restore_s": self.restore_s,
            "checkpoint_s": dict(self.store.seconds),
        }
        with open(os.path.join(self.tc.run_dir, "summary.json"), "w") as fh:
            json.dump({**out, "log": self.metrics_log}, fh, indent=1)
        return out
