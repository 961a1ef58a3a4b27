"""Bounded, backpressured chunk channels: a copy of `repro.stream.channel`.

The port imports nothing of `repro`, so it keeps its own copy of this
stdlib-only module; the token streams of `serve.ContinuousBatcher` use it.

A :class:`Channel` is a thread-safe bounded queue of ``(seq, chunk)`` pairs
with explicit end-of-stream and error propagation. ``put`` blocks while the
channel is full — that block *is* the backpressure contract: a fast producer
cannot buffer more than ``capacity`` chunks ahead of a slow consumer, so
pipeline memory stays bounded no matter how skewed the stage speeds are
(see docs/streaming.md §2).

A :class:`StreamHandle` is the producer-side fan-out view: one bounded
channel per statically-known subscriber with broadcast ``put``. A consumer
resolved from the journal (replayed — it will never read) calls
``subscribe(...).abandon()`` so the producer never blocks against a
channel nobody will drain.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

__all__ = ["Channel", "ChannelClosed", "StreamHandle"]

DEFAULT_CAPACITY = 8


class ChannelClosed(RuntimeError):
    """Put after close, or get on a channel closed with an upstream error."""


class Channel:
    """A bounded FIFO of ``(seq, chunk)`` pairs with blocking backpressure.

    Producer side: :meth:`put` (blocks while full), :meth:`close` (EOS, or
    error propagation when ``error`` is given). Consumer side: iterate —
    iteration ends at EOS and re-raises a producer error. ``stats`` records
    puts/gets, the high-watermark depth, and the total seconds producers
    spent blocked on backpressure.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY, name: str = ""):
        if capacity < 1:
            raise ValueError("channel capacity must be >= 1")
        self.capacity = capacity
        self.name = name
        self._items: deque = deque()
        self._cv = threading.Condition()
        self._closed = False
        self._abandoned = False
        self._error: Optional[BaseException] = None
        self.stats: Dict[str, float] = {
            "puts": 0,
            "gets": 0,
            "dropped": 0,
            "high_watermark": 0,
            "put_blocked_s": 0.0,
        }

    # -- producer side ------------------------------------------------------
    def put(self, seq: int, chunk: Any, timeout: Optional[float] = None) -> bool:
        """Append one chunk; block while full (backpressure).

        Returns False when the consumer abandoned the channel (the chunk is
        dropped — the producer should keep going; its durability does not
        depend on any consumer). Raises :class:`ChannelClosed` on a closed
        channel and TimeoutError if ``timeout`` elapses while blocked.
        """
        import time

        with self._cv:
            if self._abandoned:
                self.stats["dropped"] += 1
                return False
            if self._closed:
                raise ChannelClosed(f"put on closed channel {self.name!r}")
            if len(self._items) >= self.capacity:
                t0 = time.perf_counter()
                ok = self._cv.wait_for(
                    lambda: len(self._items) < self.capacity
                    or self._closed
                    or self._abandoned,
                    timeout=timeout,
                )
                self.stats["put_blocked_s"] += time.perf_counter() - t0
                if not ok:
                    raise TimeoutError(f"backpressure timeout on channel {self.name!r}")
                if self._abandoned:
                    self.stats["dropped"] += 1
                    return False
                if self._closed:
                    raise ChannelClosed(f"put on closed channel {self.name!r}")
            self._items.append((seq, chunk))
            self.stats["puts"] += 1
            self.stats["high_watermark"] = max(self.stats["high_watermark"], len(self._items))
            self._cv.notify_all()
            return True

    def close(self, error: Optional[BaseException] = None) -> None:
        """End of stream. With ``error``, consumers re-raise it on get."""
        with self._cv:
            self._closed = True
            if error is not None and self._error is None:
                self._error = error
            self._cv.notify_all()

    # -- consumer side ------------------------------------------------------
    def abandon(self) -> None:
        """Consumer walks away: pending and future puts are dropped, never
        blocked — the producer-side contract survives a dead consumer."""
        with self._cv:
            self._abandoned = True
            self._items.clear()
            self._cv.notify_all()

    def get(self, timeout: Optional[float] = None) -> Optional[Tuple[int, Any]]:
        """Next ``(seq, chunk)`` or None at EOS; re-raises a producer error."""
        with self._cv:
            ok = self._cv.wait_for(lambda: self._items or self._closed, timeout=timeout)
            if not ok:
                raise TimeoutError(f"get timeout on channel {self.name!r}")
            if self._items:
                self.stats["gets"] += 1
                item = self._items.popleft()
                self._cv.notify_all()
                return item
            if self._error is not None:
                raise ChannelClosed(
                    f"upstream of channel {self.name!r} failed: {self._error}"
                ) from self._error
            return None

    def __iter__(self) -> Iterator[Tuple[int, Any]]:
        while True:
            item = self.get()
            if item is None:
                return
            yield item

    def depth(self) -> int:
        """Chunks currently buffered (0..capacity)."""
        with self._cv:
            return len(self._items)

    @property
    def closed(self) -> bool:
        """True once the producer has signalled EOS (or failed)."""
        with self._cv:
            return self._closed


class StreamHandle:
    """Producer-side broadcast over per-subscriber bounded channels.

    Built by the scheduler with the *static* set of stream-consumer node
    ids, before the producer emits anything, so no early chunk can be
    missed. Each subscriber later calls :meth:`subscribe` for its dedicated
    channel — and, if it was resolved from the journal (it will never
    read), immediately abandons it so broadcast never blocks on it.
    Backpressure is driven by the *slowest* live subscriber.
    """

    def __init__(
        self,
        node_id: str,
        subscribers: Iterable[str] = (),
        capacity: int = DEFAULT_CAPACITY,
    ):
        self.node_id = node_id
        self.capacity = capacity
        self._channels: Dict[str, Channel] = {
            sub: Channel(capacity, name=f"{node_id}->{sub}") for sub in subscribers
        }
        self._lock = threading.Lock()
        self._closed = False

    def subscribe(self, consumer_id: str) -> Channel:
        """The dedicated channel pre-created for ``consumer_id``."""
        with self._lock:
            try:
                return self._channels[consumer_id]
            except KeyError:
                raise KeyError(
                    f"{consumer_id!r} is not a declared subscriber of "
                    f"stream {self.node_id!r}"
                ) from None

    def put(self, seq: int, chunk: Any) -> None:
        """Broadcast one chunk to every non-abandoned subscriber channel."""
        with self._lock:
            channels = list(self._channels.values())
        for ch in channels:
            ch.put(seq, chunk)

    def close(self, error: Optional[BaseException] = None) -> None:
        """Broadcast EOS (or an error) to every subscriber channel."""
        with self._lock:
            if self._closed and error is None:
                return
            self._closed = True
            channels = list(self._channels.values())
        for ch in channels:
            ch.close(error)

    def channels(self) -> List[Channel]:
        """The per-subscriber channels (introspection/tests)."""
        with self._lock:
            return list(self._channels.values())
