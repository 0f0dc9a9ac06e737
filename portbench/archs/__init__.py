"""The harness's language models, one file an architecture, named by the
``model_type`` of a configuration's ``text_config``.  ``<model_type>.py``
gives:

* ``port_text_config(port, tc)``: the port's text config at ``tc``'s sizes,
  where ``port(name)`` imports the port's module ``name``;
* ``leaves(tc)``: its parameters from the token embedding to the head, as
  ``weights.leaves`` lists them (their order sets the generator's stream);
* ``lm_flops(tc, rows, valid)``: (linear, attention) forward operations of
  ``rows`` rows over a causal mask with ``valid`` valid keys;
* ``lm_launches(tc, lm, lse)``: its attention kernels' rows of
  ``counts.step.micro_batch_launches`` over the micro-batch's sequences
  ``lm`` (queries, keys, valid keys each); ``lse`` for the trained model,
  whose forward keeps the log-sum-exp and whose backward follows;
* ``head_dim(tc)``;
* ``counters(port)``: launch counters of its own kernels, beside
  ``System.counters``'s;
* ``GROUPS``: kernel-name groups of its own kernels, which
  ``kernel_trace.table`` puts after the port's and before cuBLAS's in the
  cells that run it.

Its plain forward, for the reference, is ``reference/lm/<model_type>.py``.
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
    """The module of ``tc``'s language model."""
    return loader.load(find(tc))
