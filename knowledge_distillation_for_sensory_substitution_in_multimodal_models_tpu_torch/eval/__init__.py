"""Evaluation layer: greedy autoregressive decoding."""

from .decode import GenerateConfig, Generator

__all__ = ["GenerateConfig", "Generator"]
