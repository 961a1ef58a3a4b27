"""Retry policy and straggler watch: a copy of ``repro.core.failure``'s
``RetryPolicy`` and ``StragglerWatch`` (with the ``FailureKind`` taxonomy
they name).

The paper's §3.2 error taxonomy: heartbeat dead → SYSTEM-level failure;
heartbeat alive, app dead / timeout → APPLICATION-level failure; both alive,
latency ≫ fleet median → STRAGGLER. Speculative re-execution is safe because
tasks are atomic + deterministic (durable-execution contract): the first
commit wins in the journal. The reference's ``LivenessDetector`` (used by
its gateway) is not copied: nothing in the port polls workers yet.
"""

from __future__ import annotations

import statistics
import threading
import time
from dataclasses import dataclass
from enum import Enum
from typing import Any, Dict, List, Optional

__all__ = ["FailureKind", "RetryPolicy", "StragglerWatch"]


class FailureKind(Enum):
    HEALTHY = "healthy"
    SYSTEM = "system"  # heartbeat down ⇒ node/hardware failure
    APPLICATION = "application"  # heartbeat up, app down ⇒ software failure
    STRAGGLER = "straggler"  # alive but anomalously slow


@dataclass
class RetryPolicy:
    max_attempts: int = 3
    base_delay_s: float = 0.05
    multiplier: float = 2.0
    max_delay_s: float = 5.0
    retry_on: tuple = (FailureKind.SYSTEM, FailureKind.APPLICATION, FailureKind.STRAGGLER)

    def delay(self, attempt: int) -> float:
        return min(self.max_delay_s, self.base_delay_s * self.multiplier**attempt)

    def should_retry(self, kind: FailureKind, attempt: int) -> bool:
        return attempt < self.max_attempts and kind in self.retry_on


class StragglerWatch:
    """Detects stragglers from completed-task latency statistics.

    A running task becomes a straggler candidate when its elapsed time exceeds
    ``threshold × median(completed latencies of the same task name)`` with at
    least ``min_samples`` completions observed. The trainer uses this to issue
    a speculative duplicate to another worker (first journal commit wins).
    """

    def __init__(self, threshold: float = 2.0, min_samples: int = 3):
        self.threshold = threshold
        self.min_samples = min_samples
        self._done: Dict[str, List[float]] = {}
        self._running: Dict[tuple, float] = {}
        self._lock = threading.Lock()

    def started(self, task_name: str, token: Any) -> None:
        with self._lock:
            self._running[(task_name, token)] = time.monotonic()

    def finished(self, task_name: str, token: Any) -> None:
        with self._lock:
            t0 = self._running.pop((task_name, token), None)
            if t0 is not None:
                self._done.setdefault(task_name, []).append(time.monotonic() - t0)
                # bound memory: keep the trailing window
                if len(self._done[task_name]) > 256:
                    self._done[task_name] = self._done[task_name][-128:]

    def median(self, task_name: str) -> Optional[float]:
        with self._lock:
            xs = self._done.get(task_name, [])
            return statistics.median(xs) if len(xs) >= self.min_samples else None

    def should_speculate(
        self, task_name: str, token: Any, copies: int, max_copies: int = 3
    ) -> bool:
        """True when (task_name, token) is a straggler and a copy is allowed.

        The global-speculation decision used by the dataflow executor: the
        running attempt has been out longer than ``threshold × median`` of
        completed same-name tasks, and fewer than ``max_copies`` attempts
        (original + duplicates) exist.
        """
        if copies >= max_copies:
            return False
        with self._lock:
            xs = self._done.get(task_name, [])
            if len(xs) < self.min_samples:
                return False
            t0 = self._running.get((task_name, token))
            if t0 is None:
                return False
            return time.monotonic() - t0 > self.threshold * statistics.median(xs)

    def stragglers(self) -> List[tuple]:
        """[(task_name, token, elapsed, median), ...] currently suspect."""
        now = time.monotonic()
        out = []
        with self._lock:
            for (name, token), t0 in self._running.items():
                xs = self._done.get(name, [])
                if len(xs) < self.min_samples:
                    continue
                med = statistics.median(xs)
                if now - t0 > self.threshold * med:
                    out.append((name, token, now - t0, med))
        return out
