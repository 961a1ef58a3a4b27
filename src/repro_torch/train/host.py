"""The host boundary: every digest and every save of tensors passes through :func:`to_host`.

The durable substrate (``payload_digest``, the checkpoint store) reads arrays
through numpy, which reads neither a tensor on the card nor bfloat16. The
trainer brings each tree to the host here first, as the reference does with
``jax.device_get``.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

__all__ = ["to_host"]


def to_host(tree: Any) -> Any:
    """The tree with each tensor as a numpy array of its own on the host.

    Always a copy, also for a tensor already on the CPU, so that a save on a
    writer thread never sees the buffers a later in-place step writes. A
    bfloat16 tensor raises: numpy has no bfloat16, and the durable host boundary
    for bfloat16 waits for ROADMAP Queue 1 item 7. The reference cannot be held
    there yet: its bfloat16 checkpoints read back through ``np.load`` as ``|V2``,
    so a restored one does not digest as it was written.
    """
    if isinstance(tree, Mapping):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        if tree.dtype == torch.bfloat16:
            raise NotImplementedError(
                "to_host: a bfloat16 tensor has no numpy dtype; the durable host boundary for "
                "bfloat16 waits for ROADMAP Queue 1 item 7 (the reference's bfloat16 "
                "checkpoints read back as |V2 and do not digest as they were written)"
            )
        return tree.detach().to("cpu", copy=True).numpy()
    return tree
