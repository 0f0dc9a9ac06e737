"""Distillation losses (port of the JAX package's ``losses/``).  So far the
masked causal-LM CE; the KD losses come with the slices that need them."""

from .kd_losses import IGNORE_INDEX, masked_cross_entropy

__all__ = ["IGNORE_INDEX", "masked_cross_entropy"]
