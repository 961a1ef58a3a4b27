"""Deterministic data pipeline: a copy of ``repro.data.pipeline`` (numpy only)."""

from .pipeline import DataConfig, ShardedLoader, TokenSource, batch_digest

__all__ = ["DataConfig", "TokenSource", "ShardedLoader", "batch_digest"]
