"""Continuous-batching serving engine over the port's prefill and decode.

Counterpart of ``repro.serve.batcher``, with the same API. The unit of
compute is a fixed-shape decode step over a slot matrix: ``slots``
sequences decode one token per step; a finished slot is refilled from the
admission queue by prefilling the next request and splicing its cache into
the slot's row of the batched cache.

One deliberate difference: ``_splice_cache`` writes row ``slot`` of EVERY
cache leaf, ``pos`` included. The reference takes the element-wise
maximum of two leaves whose shapes agree, a branch meant for ``pos``; with
``slots=1`` every K/V leaf has the prefill cache's shape, so the
reference's 1-slot batcher decodes against max(old cache, new cache) and
generates wrong tokens.

Timing uses ``time.monotonic``. Reading a token back to the host
(``.item()``, ``.cpu()``) waits for the device, so every timestamp taken
after one covers the device work before it.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.stream import Channel
from repro_torch.wire import payload_digest

__all__ = ["Request", "Generation", "ContinuousBatcher"]


@dataclass
class Request:
    rid: str
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int
    submitted_at: float = field(default_factory=time.monotonic)

    def digest(self) -> str:
        return payload_digest({"p": self.prompt, "n": self.max_new_tokens})


@dataclass
class Generation:
    rid: str
    tokens: List[int]
    prompt_len: int
    queued_s: float
    prefill_s: float
    decode_s: float

    @property
    def total_s(self) -> float:
        return self.queued_s + self.prefill_s + self.decode_s


@dataclass
class _Slot:
    active: bool = False
    rid: str = ""
    produced: int = 0
    budget: int = 0
    tokens: List[int] = field(default_factory=list)
    prompt_len: int = 0
    t_admit: float = 0.0
    t_prefill_done: float = 0.0
    queued_s: float = 0.0


class ContinuousBatcher:
    """Slot-matrix continuous batching over a single model replica.

    ``max_len`` bounds prompt + generation; each slot owns a cache row of
    ``max_len``. The model's device (``model.device``) is where the cache
    lives and the steps run.
    """

    def __init__(
        self, model, params, *, slots: int = 4, max_len: int = 128, eos_id: Optional[int] = None
    ):
        self.model = model
        self.params = params
        self.n_slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.device = model.device
        self.cache = model.init_cache(slots, max_len)
        self._queue: "queue.Queue[Request]" = queue.Queue()
        self._slots = [_Slot() for _ in range(slots)]
        self._next_token = np.zeros((slots,), np.int64)
        self._done: Dict[str, Generation] = {}
        self._streams: Dict[str, Channel] = {}
        self._lock = threading.Lock()
        self.steps = 0
        self.slot_steps_busy = 0

    # -- public API ---------------------------------------------------------
    def submit(self, req: Request) -> None:
        self._queue.put(req)

    def submit_stream(self, req: Request, capacity: int = 64) -> Channel:
        """Submit a request whose tokens stream out as they decode.

        Returns a bounded :class:`repro_torch.stream.Channel` of
        ``(seq, token)`` pairs: the first token lands at prefill time, one
        more per decode step, and the channel closes when the request
        finishes. A consumer more than ``capacity`` tokens behind blocks
        the engine's step loop (backpressure).
        """
        ch = Channel(capacity, name=f"tokens:{req.rid}")
        with self._lock:
            self._streams[req.rid] = ch
        self._queue.put(req)
        return ch

    def run_until_drained(self, max_steps: int = 100_000) -> Dict[str, Generation]:
        """Drive the loop until queue and slots are empty (batch-mode serving)."""
        while (not self._queue.empty() or self._any_active()) and self.steps < max_steps:
            self.step()
        return dict(self._done)

    def results(self) -> Dict[str, Generation]:
        return dict(self._done)

    # -- internals ------------------------------------------------------------
    def _any_active(self) -> bool:
        return any(s.active for s in self._slots)

    def _admit(self) -> None:
        """Fill free slots: prefill the request and splice its cache in."""
        for i, slot in enumerate(self._slots):
            if slot.active:
                continue
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            t0 = time.monotonic()
            toks = torch.as_tensor(np.asarray(req.prompt), dtype=torch.long, device=self.device)
            logits, fresh = self.model.prefill(
                self.params, {"tokens": toks[None, :]}, pad_to=self.max_len
            )
            _splice_cache(self.cache, fresh, i)
            first = int(torch.argmax(logits, dim=-1)[0])  # waits for the device
            self._next_token[i] = first
            slot.active = True
            slot.rid = req.rid
            slot.produced = 1
            slot.budget = req.max_new_tokens
            slot.tokens = [first]
            slot.prompt_len = len(req.prompt)
            slot.queued_s = t0 - req.submitted_at
            slot.t_admit = t0
            slot.t_prefill_done = time.monotonic()
            ch = self._streams.get(req.rid)
            if ch is not None:
                ch.put(0, first)  # first token streams out at prefill time

    def step(self) -> None:
        """One engine iteration: admit, then decode one token for every slot."""
        self._admit()
        if not self._any_active():
            return
        tok = torch.as_tensor(self._next_token, device=self.device)
        logits, self.cache = self.model.decode_step(self.params, self.cache, {"token": tok})
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()  # waits for the device
        self.steps += 1
        for i, slot in enumerate(self._slots):
            if not slot.active:
                continue
            self.slot_steps_busy += 1
            t = int(nxt[i])
            done = (
                slot.produced >= slot.budget
                or (self.eos_id is not None and t == self.eos_id)
                or slot.prompt_len + slot.produced + 1 >= self.max_len
            )
            if done:
                now = time.monotonic()
                self._done[slot.rid] = Generation(
                    rid=slot.rid,
                    tokens=list(slot.tokens),
                    prompt_len=slot.prompt_len,
                    queued_s=slot.queued_s,
                    prefill_s=slot.t_prefill_done - slot.t_admit,
                    decode_s=now - slot.t_prefill_done,
                )
                ch = self._streams.pop(slot.rid, None)
                if ch is not None:
                    ch.close()  # EOS: the consumer's iteration ends
                self._slots[i] = _Slot()
                self._next_token[i] = 0
            else:
                slot.tokens.append(t)
                slot.produced += 1
                self._next_token[i] = t
                ch = self._streams.get(slot.rid)
                if ch is not None:
                    ch.put(len(slot.tokens) - 1, t)

    def utilization(self) -> float:
        """Mean fraction of slots busy per decode step."""
        if self.steps == 0:
            return 0.0
        return self.slot_steps_busy / (self.steps * self.n_slots)


def _splice_cache(batched, fresh, slot: int) -> None:
    """Write the batch-1 ``fresh`` cache into row ``slot`` of ``batched``, in place.

    Every leaf of a stacked cache is (layers, batch, ...), so the batch
    axis is 1 for all of them, ``pos`` included; every other axis must agree.
    """
    for key, b in batched.items():
        f = fresh[key]
        if isinstance(b, dict):
            _splice_cache(b, f, slot)
            continue
        row, new = b[:, slot], f[:, 0]
        if row.shape != new.shape:
            raise ValueError(f"cache leaf {key!r}: fresh {tuple(f.shape)}, slots {tuple(b.shape)}")
        row.copy_(new)
