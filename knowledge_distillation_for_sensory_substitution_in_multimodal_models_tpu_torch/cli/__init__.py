"""CLI entry points with the JAX package's flags.

``inference`` <-> the JAX package's ``cli/inference.py``;
``train`` <-> its ``cli/train.py`` (the baseline trainer).
"""
