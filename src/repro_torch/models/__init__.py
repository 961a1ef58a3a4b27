"""Model substrate: the dense decoder stack of the JAX package, in PyTorch."""

from .model import Model, build, padded_vocab

__all__ = ["Model", "build", "padded_vocab"]
