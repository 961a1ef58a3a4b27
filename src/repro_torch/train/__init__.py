"""Training: the step functions (forward, loss, backward, clip, AdamW)."""

from .steps import make_decode_step, make_opt_init, make_prefill_step, make_train_step

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step", "make_opt_init"]
