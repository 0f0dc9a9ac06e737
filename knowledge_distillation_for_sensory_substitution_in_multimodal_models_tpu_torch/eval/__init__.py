"""Evaluation layer: greedy autoregressive decoding (``decode``), the
reference's metrics (``metrics``) and the predictions summary (``results``)."""

from .decode import GenerateConfig, Generator

__all__ = ["GenerateConfig", "Generator"]
