"""Deterministic sharded data pipeline: a copy of ``repro.data.pipeline``.

The port imports nothing of ``repro``, so it keeps its own copy of this
numpy-only module; ``tests/test_torch_train.py`` holds its batches equal to
the reference's bit for bit. ``batch_digest`` goes through the port's
``wire.payload_digest``, the same digest.

Design requirements (the durable-execution contract applied to data):
  - every batch is a pure function of (seed, step, shard): replays are
    bit-identical, so a restarted run consumes exactly the same tokens;
  - per-host sharding: host h of H draws rows [h·B/H, (h+1)·B/H) of the
    global batch, with no coordination and no duplication;
  - a background prefetch thread with a bounded queue hides generation latency.

The source is a synthetic token stream (a zipfian unigram mixture with
deterministic per-document seeds): the paper has no dataset. A real corpus
drops in by replacing ``TokenSource``.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

from repro_torch.wire import payload_digest

__all__ = ["DataConfig", "TokenSource", "ShardedLoader", "batch_digest"]


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_index: int = 0
    zipf_a: float = 1.3
    prefetch: int = 2


class TokenSource:
    """Deterministic synthetic corpus: batch = f(seed, step, host shard)."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.num_hosts:
            raise ValueError("global batch must divide across hosts")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.num_hosts
        # zipfian unigram table (shared, seed-derived)
        rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = ranks**-cfg.zipf_a
        self._probs = probs / probs.sum()
        self._perm = rng.permutation(cfg.vocab_size)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The (host-local) batch for a given global step. Pure."""
        cfg = self.cfg
        row0 = cfg.host_index * self.local_batch
        rows = []
        for r in range(self.local_batch):
            doc_seed = (cfg.seed * 1_000_003 + step) * 100_003 + row0 + r
            rng = np.random.default_rng(doc_seed)
            toks = rng.choice(cfg.vocab_size, size=cfg.seq_len, p=self._probs)
            rows.append(self._perm[toks])
        return {"tokens": np.stack(rows).astype(np.int32)}


class ShardedLoader:
    """Prefetching iterator over a TokenSource, resumable at any step."""

    def __init__(self, source: TokenSource, start_step: int = 0):
        self.source = source
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=source.cfg.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self) -> None:
        step = self.step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, batch = self._q.get()
        self.step = step + 1
        return step, batch

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def batch_digest(batch: Dict[str, np.ndarray]) -> str:
    """Digest used by the durable journal to prove replayed data identity."""
    return payload_digest(batch)
