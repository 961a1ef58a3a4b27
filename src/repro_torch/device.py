"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device``. With none given it means
``cuda``, and a machine without a CUDA card raises instead of quietly
running on the CPU: a run that asked for the card must not report CPU
numbers. Tests pass ``device="cpu"``.
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device", "DeviceLike"]

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` (default ``cuda``) as a :class:`torch.device`, checked.

    Also pins float32 matmuls and convolutions to full float32. The model
    is float32 end to end and its parity tolerances against the JAX
    package (1e-4 on logits, 2e-5 on attention) do not survive TF32, which
    keeps about three decimal digits.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA device requested (the default) but torch.cuda.is_available() "
            "is False; pass device='cpu' explicitly to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"repro_torch: unsupported device {dev}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev

