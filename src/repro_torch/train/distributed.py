"""Distributed data-parallel training on the cluster substrate, the counterpart of
``repro.train.distributed``.

Every training step expands into a small cluster graph routed through the
Gateway (the SparkNet shape: deep-network training AS distributed dataflow):

    apply@s-1 ──► sync@s ──► grad@s#0 ─┐
                      │      grad@s#1 ─┼──► reduce@s ──► apply@s ──► ...
                      │      ...       │
                      └────► grad@s#N ─┘           └──► ckpt@e (round end)

  - ``sync@s``   publishes the current params as host arrays (digest-
                 precomputed via :class:`~repro_torch.wire.Digested` so N
                 consumers hash O(1));
  - ``grad@s#k`` is a *named registry task* (``"grad_shard"``) dispatched to
                 a gateway worker: it regenerates shard k of the global batch
                 deterministically (batch = f(seed, step, shard)) and returns
                 that shard's gradients as host arrays;
  - ``reduce@s`` folds the shard gradients into their mean, in fixed shard
                 order (bit-deterministic regardless of which worker computed
                 which shard);
  - ``apply@s``  moves the mean to the trainer's device, runs the out-of-place
                 AdamW update, verifies the step's metric digest against the
                 journal BEFORE swapping in the new state, and journals the
                 step metrics (the replay oracle).

The node ids, their data, aliases, volatility and retries are the
reference's, so on the same params the port's journal holds the reference's
context digests and the input digests of ``sync@s`` and ``grad@s#k``
(``tests/test_torch_distributed.py``). Tensor-bearing nodes (sync, grad,
reduce) are *volatile*: their commits carry only digests, never tensors, and
recovery re-executes them from the restored snapshot. A worker evicted
mid-round has its shard requeued on a survivor by the gateway; the round
completes with the same gradients because ``grad_shard`` is a pure function
of (params, step, shard). A killed run resumes from the newest complete
checkpoint pair and verifies every re-executed step against the journal.

A bfloat16 model's shard gradients come to the host as ``BFloat16Array`` bits; the
mean widens them to float32 and rounds once, as the reference's does its ``ml_dtypes``
arrays, so both give the same bits.

On the card each ``grad_shard`` runs the model's flash forward (with the
logsumexp) and backward kernels. Its gradients must not depend on the worker
or on the shards running beside it on the one card: the trainer runs under
``torch.use_deterministic_algorithms(True)`` with ``CUBLAS_WORKSPACE_CONFIG``
set (``Trainer`` refuses the card without it), and every task runs on the
device's default stream. Grad mode and the current device are per thread in
PyTorch, so the task sets both on the worker's thread.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import (
    ClusterExecutor,
    ContextGraph,
    Gateway,
    InProcWorker,
    TaskRegistry,
)
from repro_torch.data.pipeline import DataConfig, TokenSource
from repro_torch.device import DeviceLike
from repro_torch.models import Model
from repro_torch.optim.adamw import adamw_update, tree_map
from repro_torch.params import from_numpy_tree
from repro_torch.wire import Digested, payload_digest
from repro_torch.wire.bfloat16 import BFloat16Array, from_float32

from .host import to_host
from .steps import value_and_grad
from .trainer import TrainConfig, Trainer

__all__ = ["DistTrainConfig", "DistributedTrainer", "build_grad_registry"]


@dataclass
class DistTrainConfig(TrainConfig):
    """Trainer config plus the data-parallel topology knobs."""

    num_shards: int = 4  # gradient shards per step (global_batch must divide)
    num_workers: int = 4  # default in-proc worker pool size
    heartbeat_interval_s: float = 0.1  # gateway probe cadence (eviction speed)
    speculative: bool = False  # straggler duplicates are off for uniform shards


@contextlib.contextmanager
def _on_device(dev: torch.device) -> Iterator[None]:
    """Grad on and, on a card, ``dev`` current: both are per thread in PyTorch, and a
    worker's thread inherits neither from the thread that started the worker."""
    with torch.enable_grad():
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                yield
        else:
            yield


def build_grad_registry(model: Model, data_cfg: DataConfig) -> TaskRegistry:
    """Registry exposing the tensor-bearing ``grad_shard`` task.

    The task contract: inputs carry ``sync = {"step", "params"}`` (injected
    from the round graph's sync node; params as host arrays); the *context*
    carries Ψ facts ``shard`` / ``num_shards`` — the shard identity is
    context, not payload, so the same submitted request is cheap to requeue
    on any worker. The shard batch is regenerated locally from (seed, step,
    shard): workers never ship training data, only gradients. Loss and
    gradients are computed on ``model.device``; the gradients come back as
    host arrays in the params' dtype (bfloat16 as ``BFloat16Array`` bits), so
    their digests do not depend on the transport.

    A deployment calls this on each worker host to register the task with
    its :class:`~repro_torch.core.WorkerServer`; in-proc workers share one
    registry instance.
    """
    registry = TaskRegistry()
    dev = model.device

    @registry.task("grad_shard")
    def grad_shard(ctx, sync):
        shard = int(ctx.get("shard"))
        num_shards = int(ctx.get("num_shards"))
        step = int(sync["step"])
        # a source of the task's own (building it costs less than drawing its batch): a cache
        # shared across calls would be state the task mutates, which replay forbids
        src = TokenSource(dataclasses.replace(data_cfg, num_hosts=num_shards, host_index=shard))
        batch = src.batch_at(step)  # deterministic: f(seed, step, shard)
        with _on_device(dev):
            tbatch = {k: torch.from_numpy(v).long().to(dev) for k, v in batch.items()}
            params = from_numpy_tree(sync["params"], dev)
            (loss, _metrics), grads = value_and_grad(model.loss_fn, params, tbatch)
            # plain host arrays, no Digested wrapper: worker results must
            # journal under transport-independent digests, and an HTTP
            # transport would strip the wrapper anyway
            return {"shard": shard, "loss": float(loss), "grads": to_host(grads)}

    return registry


def _mean_pytrees(trees: Sequence[Any]) -> Any:
    """Leaf-wise mean in *list order* — bit-deterministic shard aggregation: each
    shard's leaf widened to float32, added in list order, divided by the count, and the
    mean rounded once to the leaf's dtype (a bfloat16 leaf, a ``BFloat16Array``, to
    nearest even, as the reference's ``ml_dtypes`` cast)."""
    n = len(trees)

    def wide(leaf):
        if isinstance(leaf, BFloat16Array):
            return leaf.float32()
        return np.asarray(leaf, dtype=np.float32)

    def mean_leaf(*leaves):
        acc = wide(leaves[0]).copy()
        for leaf in leaves[1:]:
            acc += wide(leaf)
        if isinstance(leaves[0], BFloat16Array):
            return from_float32(acc / n)
        return (acc / n).astype(np.asarray(leaves[0]).dtype)

    return tree_map(mean_leaf, *trees)


class DistributedTrainer(Trainer):
    """Data-parallel :class:`Trainer` running rounds through the Gateway.

    Inherits the whole durable-round machinery (journal scan, recovery from
    the newest complete checkpoint pair, metric collection, summary) and
    overrides exactly two seams: the round graph (data-parallel expansion)
    and the executor scope (a gateway-backed :class:`ClusterExecutor`).
    """

    step_node_prefix = "apply@"

    def __init__(
        self,
        cfg: ModelConfig,
        tc: DistTrainConfig,
        workers: Optional[List[Any]] = None,
        device: DeviceLike = None,
    ):
        super().__init__(cfg, tc, device)
        if tc.global_batch % tc.num_shards:
            raise ValueError(
                f"global_batch={tc.global_batch} must divide across num_shards={tc.num_shards}"
            )
        self.registry = build_grad_registry(self.model, self.data_cfg)
        # each default worker models ONE accelerator host: capacity 1 —
        # the gateway may hand it several shard requests, it executes them
        # one at a time (parallelism comes from more workers, not threads)
        self.workers = (
            workers
            if workers is not None
            else [
                InProcWorker(f"w{i}", self.registry, max_concurrency=1)
                for i in range(tc.num_workers)
            ]
        )
        self.gateway: Optional[Gateway] = None  # live only inside train()

    def _apply(self, params, opt_state, grads):
        """The out-of-place AdamW step on the mean gradient (host arrays)."""
        with torch.no_grad():
            grads = from_numpy_tree(grads, self.device)
            return adamw_update(params, grads, opt_state, self.tc.opt)

    # -- executor seam ------------------------------------------------------
    @contextlib.contextmanager
    def _executor_scope(self) -> Iterator[Any]:
        """Start the gateway for the run; yield a cluster executor on it."""
        tc: DistTrainConfig = self.tc
        self.gateway = Gateway(
            self.workers,
            heartbeat_interval_s=tc.heartbeat_interval_s,
            name="train-gateway",
        )
        self.gateway.start()
        try:
            yield ClusterExecutor(self.gateway, journal=self.journal, speculative=tc.speculative)
        finally:
            self.gateway.stop()
            self.gateway = None

    # -- the data-parallel round graph --------------------------------------
    def _round_graph(
        self,
        start: int,
        end: int,
        state: Dict[str, Any],
        replay_digests: Dict[int, str],
        incarnation: int = 0,
    ) -> ContextGraph:
        """K steps, each fanned out over ``num_shards`` gradient tasks.

        Volatile nodes (sync/grad/reduce) re-execute on recovery; the apply
        node is the stateful one — it carries the incarnation nonce in Ψ
        (same contract as the local trainer's step nodes), verifies its
        metric digest against the journal, and only then swaps the state.
        """
        g = ContextGraph(origin=self.run_context(), name=f"round{start}")
        num_shards: int = self.tc.num_shards
        prev_apply = None
        for s in range(start, end):
            sync_id, reduce_id = f"sync@{s}", f"reduce@{s}"
            apply_id = f"apply@{s}"

            def sync(ctx, _s=s, **deps):
                # publish the live params once per step; Digested makes the
                # N shard consumers (and the commit) hash it in O(1)
                return {"step": _s, "params": Digested.wrap(to_host(state["params"]))}

            g.add(
                sync_id,
                sync,
                deps=[prev_apply] if prev_apply else [],
                volatile=True,
                retries=0,
            )

            grad_ids = []
            for k in range(num_shards):
                gid = f"grad@{s}#{k}"
                g.add(
                    gid,
                    "grad_shard",
                    deps=[sync_id],
                    aliases={sync_id: "sync"},
                    data={"shard": k, "num_shards": num_shards},
                    volatile=True,
                )
                grad_ids.append(gid)

            shard_order = tuple(grad_ids)

            def reduce_(ctx, _ids=shard_order, **deps):
                shards = [deps[i] for i in _ids]  # fixed shard order
                grads = _mean_pytrees([sh["grads"] for sh in shards])
                loss = float(sum(sh["loss"] for sh in shards) / len(shards))
                return {"grads": Digested.wrap(grads), "loss": loss}

            g.add(reduce_id, reduce_, deps=grad_ids, volatile=True, retries=0)

            def apply_(ctx, _s=s, _rid=reduce_id, **deps):
                red = deps[_rid]
                want = replay_digests.get(_s)
                # compute-then-verify-then-swap: the optimizer update is out
                # of place, so a digest mismatch leaves the restored state
                # exactly as the snapshot left it
                new_params, new_opt, metrics = self._apply(
                    state["params"], state["opt"], red["grads"]
                )
                out = {
                    "step": _s,
                    "loss": red["loss"],
                    "grad_norm": float(metrics["grad_norm"]),
                    "lr": float(metrics["lr"]),
                }
                got = payload_digest(out)
                if want is not None and want != got:
                    raise RuntimeError(
                        f"non-deterministic replay at step {_s}: journal={want} recomputed={got}"
                    )
                state["params"], state["opt"] = new_params, new_opt
                return out

            g.add(
                apply_id,
                apply_,
                deps=[reduce_id],
                data={"incarnation": incarnation},
                retries=0,
            )
            prev_apply = apply_id

        self._add_checkpoint_node(g, state, prev_apply, end)
        return g
