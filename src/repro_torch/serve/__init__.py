"""Serving engine: continuous batching over one model replica."""

from .batcher import ContinuousBatcher, Generation, Request

__all__ = ["ContinuousBatcher", "Generation", "Request"]
