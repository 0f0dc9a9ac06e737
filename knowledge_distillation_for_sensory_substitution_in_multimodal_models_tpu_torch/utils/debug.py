"""Runtime debug switches (port of the JAX package's ``utils/debug.py``;
SURVEY.md §5 "race detection / sanitizers": the reference has none).

* :func:`enable_nan_checks`, the JAX ``jax_debug_nans``: autograd's anomaly
  mode (a backward that makes a NaN raises, naming the forward op that
  recorded it) and a global forward hook that raises on the first module
  whose floating output holds a NaN or an infinity, naming the module.
* :func:`deterministic_mode`, a region whose runs repeat bit for bit:
  ``torch.use_deterministic_algorithms(True)`` (PyTorch's own ops take their
  deterministic kernels or raise), TF32 off in matrix products and cuDNN,
  float32 matmul precision "highest" (the JAX mode pins the same
  precision), and ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, which cuBLAS needs
  for deterministic products; it yields a ``torch.Generator`` seeded with
  ``seed`` (the JAX mode yields ``PRNGKey(seed)``) and restores every
  setting on exit.

The port's kernels need no switch of their own: each sums in a fixed order
(the flash backwards reduce dk/dv partials in a fixed order,
``csrc/flash_bwd_sm90.cu:15`` and ``csrc/flash_bwd_d72_sm90.cu:15``; the
vocab core combines its per-split partials in split order), and the one
atomic, K3's ``atomicAdd`` on its tile counter
(``csrc/flash_gqa_sm90.cuh:264``), only hands out tiles, whose sums do not
depend on which block takes them.  So no kernel refuses the mode.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch import nn

_NAN_HOOK = [None]


def _raise_on_non_finite(module: nn.Module, inputs, output) -> None:
    for t in output if isinstance(output, (tuple, list)) else (output,):
        if isinstance(t, torch.Tensor) and t.is_floating_point() and not torch.isfinite(t).all():
            raise FloatingPointError(
                f"{type(module).__name__} produced a non-finite output (shape {tuple(t.shape)}, {t.dtype})")


def enable_nan_checks() -> None:
    """Raise on the first NaN or infinity a module outputs (a forward hook
    on every module, the raising module named) and on one a backward makes
    (autograd's anomaly mode).  Both cost a device-to-host read per check:
    a debugging switch, not for timed runs."""
    torch.autograd.set_detect_anomaly(True)
    if _NAN_HOOK[0] is None:
        _NAN_HOOK[0] = nn.modules.module.register_module_forward_hook(_raise_on_non_finite)


def disable_nan_checks() -> None:
    """Undo :func:`enable_nan_checks`."""
    torch.autograd.set_detect_anomaly(False)
    if _NAN_HOOK[0] is not None:
        _NAN_HOOK[0].remove()
        _NAN_HOOK[0] = None


_CUBLAS_WORKSPACE = ":4096:8"


@contextlib.contextmanager
def deterministic_mode(seed: int = 0):
    """Bitwise-deterministic region (see the module docstring); yields a
    ``torch.Generator`` seeded with ``seed``."""
    prev = (torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision(), os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = _CUBLAS_WORKSPACE
    try:
        yield torch.Generator().manual_seed(seed)
    finally:
        algos, warn_only, tf32, cudnn_tf32, precision, workspace = prev
        torch.use_deterministic_algorithms(algos, warn_only=warn_only)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        torch.set_float32_matmul_precision(precision)
        if workspace is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = workspace
