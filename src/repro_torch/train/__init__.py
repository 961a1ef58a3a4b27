"""Training: the step functions (forward, loss, backward, clip, AdamW) and the durable
``Trainer`` that runs them as journaled, checkpointed, replay-verified rounds."""

from .steps import (
    make_decode_step,
    make_donating_train_step,
    make_opt_init,
    make_prefill_step,
    make_train_step,
)
from .trainer import TrainConfig, Trainer

__all__ = [
    "TrainConfig",
    "Trainer",
    "make_train_step",
    "make_donating_train_step",
    "make_prefill_step",
    "make_decode_step",
    "make_opt_init",
]
