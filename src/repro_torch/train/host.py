"""The host boundary: every digest and every save of tensors passes through :func:`to_host`.

The durable substrate (``payload_digest``, the checkpoint store) reads arrays
through numpy, which reads no tensor on the card and has no bfloat16. The
trainer brings each tree to the host here first, as the reference does with
``jax.device_get``.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from repro_torch.wire.bfloat16 import BFloat16Array

__all__ = ["to_host"]


def to_host(tree: Any) -> Any:
    """The tree with each tensor as a numpy array of its own on the host.

    Always a copy, also for a tensor already on the CPU, so that a save on a
    writer thread never sees the buffers a later in-place step writes. A
    bfloat16 tensor comes as a :class:`~repro_torch.wire.bfloat16.BFloat16Array`
    of its bits, which digests, encodes and checkpoints as the reference's
    ``ml_dtypes.bfloat16`` array with the same bits, and which
    ``repro_torch.params.from_numpy_tree`` takes back to a bfloat16 tensor.
    """
    if isinstance(tree, Mapping):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        host = tree.detach().to("cpu", copy=True)
        if host.dtype == torch.bfloat16:
            return BFloat16Array(host.view(torch.int16).numpy())
        return host.numpy()
    return tree
