"""Compute primitives: plain attention (``attention``), the flash-attention
forward and backward kernel wrappers (``flash_attention``) and the forward's
phase-ablation arms (``flash_phase_ablation``), the fused cross-entropy
(``fused_ce``) and the kernel library's build (``_build``)."""

from .attention import dot_product_attention

__all__ = ["dot_product_attention"]
