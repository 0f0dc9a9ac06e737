"""Distillation losses (port of the JAX package's ``losses/``): the masked
causal-LM CE, the temperature KL, the LoCa term (paper-correct or faithful),
NT-Xent, OFA, feature MSE and the phase-1 vision loss (``kd_losses.py``),
and the row-chunked terms and the chunked faithful LoCa (``chunked.py``)."""

from .kd_losses import (
    IGNORE_INDEX,
    feature_mse_loss,
    kd_kl_loss,
    loca_calibrated_probs,
    loca_loss,
    masked_cross_entropy,
    masked_ntxent_loss,
    ntxent_loss,
    ofa_loss,
    pool_and_normalize,
    truncate_teacher_logits,
    vision_phase1_loss,
)

__all__ = [
    "IGNORE_INDEX",
    "feature_mse_loss",
    "kd_kl_loss",
    "loca_calibrated_probs",
    "loca_loss",
    "masked_cross_entropy",
    "masked_ntxent_loss",
    "ntxent_loss",
    "ofa_loss",
    "pool_and_normalize",
    "truncate_teacher_logits",
    "vision_phase1_loss",
]
