"""repro_torch: the PyTorch/CUDA port of the SerPyTor compute layer.

A package beside ``repro`` (the JAX reference, which it never imports).
It serves decoder LMs (dense, hybrid RG-LRU, RWKV6) through
:class:`repro_torch.serve.ContinuousBatcher` and trains the dense ones
through :func:`repro_torch.train.make_train_step` (the reference's loss and
AdamW), with attention, its gradient and the recurrences in hand-written
Hopper kernels (``kernels/csrc/``). Entry points run on ``cuda`` unless
given ``device="cpu"``, and raise when asked for a card that is not there.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
