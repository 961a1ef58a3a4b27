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
    bfloat16 tensor raises: no bfloat16 model trains in the port yet.
    """
    if isinstance(tree, Mapping):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        if tree.dtype == torch.bfloat16:
            raise NotImplementedError(
                "to_host: a bfloat16 tensor has no numpy dtype, and no bfloat16 model trains "
                "in the port yet: ROADMAP Queue 1 item 7"
            )
        return tree.detach().to("cpu", copy=True).numpy()
    return tree
