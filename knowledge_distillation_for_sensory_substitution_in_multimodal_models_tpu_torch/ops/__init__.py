"""Compute primitives: plain attention (``attention``), the flash-attention
forward kernel wrappers (``flash_attention``) and the kernel library's build
(``_build``)."""

from .attention import dot_product_attention

__all__ = ["dot_product_attention"]
