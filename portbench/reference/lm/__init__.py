"""The reference's language models, one file an architecture, named by the
``model_type`` of a configuration's ``text_config`` (the key of the
published HF ``config.json``).  Each file gives ``forward(W, tc, x, valid,
precision, ckpt)``: x [B, S, D] input embeddings, valid [B, S] the real
tokens (right padded) -> the final-norm hidden states [B, S, D].

Files are loaded by path (``portbench/loader.py``) from ``DIR``, which a
test may point elsewhere.
"""

from __future__ import annotations

from pathlib import Path

from portbench import loader

DIR = Path(__file__).resolve().parent


def find(tc: dict) -> Path:
    return loader.model_file(DIR, tc)


def of(tc: dict):
    """The reference's module of ``tc``'s language model."""
    return loader.load(find(tc))
