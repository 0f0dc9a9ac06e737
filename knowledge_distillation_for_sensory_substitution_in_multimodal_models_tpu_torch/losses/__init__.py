"""Distillation losses (port of the JAX package's ``losses/``): the masked
causal-LM CE, the temperature KL, the paper-correct LoCa term and NT-Xent;
OFA and feature MSE are not ported."""

from .kd_losses import (
    IGNORE_INDEX,
    kd_kl_loss,
    loca_calibrated_probs,
    loca_loss,
    masked_cross_entropy,
    masked_ntxent_loss,
    ntxent_loss,
    pool_and_normalize,
    truncate_teacher_logits,
)

__all__ = [
    "IGNORE_INDEX",
    "kd_kl_loss",
    "loca_calibrated_probs",
    "loca_loss",
    "masked_cross_entropy",
    "masked_ntxent_loss",
    "ntxent_loss",
    "pool_and_normalize",
    "truncate_teacher_logits",
]
