"""Optimizers: the reference's own AdamW with global-norm clipping and LR schedules."""

from .adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    adamw_update_,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
    linear_warmup_cosine,
)

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "adamw_update_",
    "global_norm",
    "clip_by_global_norm",
    "cosine_schedule",
    "linear_warmup_cosine",
]
