"""Distillation losses (port of the JAX package's ``losses/``): the masked
causal-LM CE and the paper-correct LoCa term; the other KD losses come with
the slices that need them."""

from .kd_losses import (
    IGNORE_INDEX,
    loca_calibrated_probs,
    loca_loss,
    masked_cross_entropy,
    truncate_teacher_logits,
)

__all__ = [
    "IGNORE_INDEX",
    "loca_calibrated_probs",
    "loca_loss",
    "masked_cross_entropy",
    "truncate_teacher_logits",
]
