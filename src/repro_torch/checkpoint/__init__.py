"""Checkpoints: the reference's on-disk format, content-digested, atomically published."""

from .store import CheckpointStore, atomic_write_bytes

__all__ = ["CheckpointStore", "atomic_write_bytes"]
