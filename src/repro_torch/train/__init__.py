"""Training: the step functions (forward, loss, backward, clip, AdamW), the durable
``Trainer`` that runs them as journaled, checkpointed, replay-verified rounds, and the
data-parallel ``DistributedTrainer`` whose rounds fan out over gateway workers."""

from .distributed import DistributedTrainer, DistTrainConfig, build_grad_registry
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
    "DistTrainConfig",
    "DistributedTrainer",
    "build_grad_registry",
    "make_train_step",
    "make_donating_train_step",
    "make_prefill_step",
    "make_decode_step",
    "make_opt_init",
]
