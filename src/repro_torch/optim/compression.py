"""Gradient compression for cross-pod reduction: low-precision + error feedback, the
counterpart of ``repro.optim.compression`` on torch tensors.

Compressing gradients to bf16 (or int8 with per-block scales) before a
reduction halves (quarters) its bytes; ERROR FEEDBACK carries the
quantization residual into the next step so the compression bias does not
accumulate (Seide et al. / 1-bit Adam lineage — convergence-neutral in
expectation for smooth losses).

Usage:
    comp = GradCompressor(kind="bf16")      # or "int8"
    cgrads, state = comp.compress(grads, state)   # before the reduce
    grads = comp.decompress(cgrads)               # after reduction

Trees are nested dicts of tensors. The same arithmetic in the same order as
the reference: the bf16 cast is bit for bit the reference's, and int8
rounds half to even as it does (``tests/test_torch_compression.py``). As in
the reference, no trainer calls it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import torch
import torch.nn.functional as F

__all__ = ["GradCompressor"]

_BLOCK = 256  # int8 scale granularity (per trailing block)


def _map(fn, tree, *rest):
    if isinstance(tree, dict) and not GradCompressor._is_q(tree):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


@dataclass(frozen=True)
class GradCompressor:
    kind: str = "bf16"  # bf16 | int8 | none

    # -- error-feedback state ------------------------------------------------
    def init_state(self, grads) -> Any:
        if self.kind == "none":
            return None
        return _map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)

    # -- compress -------------------------------------------------------------
    def compress(self, grads, err_state) -> Tuple[Any, Any]:
        """(compressed, new_err_state). Residual = (g+e) - Q(g+e)."""
        if self.kind == "none":
            return grads, err_state

        def one(g, e):
            corrected = g.float() + e
            q = self._quantize(corrected)
            return q, corrected - self._dequantize(q)

        pairs = _map(one, grads, err_state)
        return _map(lambda p: p[0], pairs), _map(lambda p: p[1], pairs)

    def decompress(self, compressed) -> Any:
        if self.kind == "none":
            return compressed
        return _map(self._dequantize, compressed)

    # -- codecs ----------------------------------------------------------------
    def _quantize(self, x: torch.Tensor):
        if self.kind == "bf16":
            return x.to(torch.bfloat16)
        # int8 with per-block absmax scales
        flat = x.reshape(-1)
        flat = F.pad(flat, (0, (-flat.numel()) % _BLOCK))
        blocks = flat.reshape(-1, _BLOCK)
        scale = torch.amax(blocks.abs(), dim=1, keepdim=True) / 127.0
        scale = torch.clamp(scale, min=1e-12)
        q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
        return {"q": q, "scale": scale.float(), "shape": tuple(x.shape), "n": x.numel()}

    def _dequantize(self, q):
        if self.kind == "bf16" or not self._is_q(q):
            return q.float() if isinstance(q, torch.Tensor) else q
        flat = (q["q"].float() * q["scale"]).reshape(-1)[: q["n"]]
        return flat.reshape(q["shape"])

    @staticmethod
    def _is_q(x) -> bool:
        return isinstance(x, dict) and set(x) == {"q", "scale", "shape", "n"}

    # -- accounting --------------------------------------------------------------
    def bytes_ratio(self) -> float:
        return {"none": 1.0, "bf16": 0.5, "int8": 0.25 + 4.0 / _BLOCK}[self.kind]
