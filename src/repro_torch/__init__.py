"""repro_torch: the PyTorch/CUDA port of the SerPyTor compute layer.

A package beside ``repro`` (the JAX reference, which it never imports).
This slice serves decoder LMs of the dense kind, ``serpytor-demo-100m``
at full size, through :class:`repro_torch.serve.ContinuousBatcher`, with
prefill attention in a hand-written Hopper kernel
(``kernels/csrc/flash_attention_fwd.cu``). Entry points run on ``cuda``
unless given ``device="cpu"``, and raise when asked for a card that is
not there.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
