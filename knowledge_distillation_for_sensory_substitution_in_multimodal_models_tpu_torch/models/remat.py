"""Per-layer rematerialization (the JAX package's ``nn.remat`` of a layer
with ``models/qwen2.py::_remat_policy``), on ``torch.utils.checkpoint``
(non-reentrant).  The backward recomputes what the policy does not save:

* ``"full"``: the whole layer; only its inputs are kept;
* ``"dots"``: the outputs of the weight products (the q/k/v/o, gate/up/down
  and SigLIP projections, which reach the dispatcher as ``aten.mm`` and
  ``aten.addmm``) are saved through a selective-checkpoint policy, and the
  rest is recomputed (the JAX ``dots_with_no_batch_dims_saveable``: the
  attention's batched products are recomputed);
* ``"flash"``: the flash forward's ``out`` and ``lse`` are kept, so the
  recompute does not launch the flash forward again (the JAX
  ``save_only_these_names("flash_out", "flash_lse")``).  The forward is a
  ``torch.autograd.Function`` over a ctypes launch, which a selective
  policy cannot see, so the layer runs under an explicit
  ``ops/flash_attention.py::FlashSaveCache`` that the recompute reads.

A call without autograd (the frozen teacher under ``no_grad``, serving)
runs the layer as it is: there is no backward to recompute for.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from ..ops.flash_attention import FlashSaveCache, save_flash_outputs

REMAT_POLICIES = ("full", "dots", "flash")
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def check_policy(name: str) -> str:
    """The policy name (``""`` and None read as ``"full"``, as in JAX)."""
    name = name or "full"
    if name not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {name!r} (use one of {REMAT_POLICIES})")
    return name


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOT_OPS else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_save_dots)


def needs_remat(*tensors: torch.Tensor) -> bool:
    """Whether a call builds a graph that a backward will walk."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def remat_call(fn: Callable, policy: str, *args):
    """``fn(*args)`` under a checkpoint of ``policy`` (see the module)."""
    if policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False, context_fn=_dots_context)
    if policy == "flash":
        cache = FlashSaveCache()

        def run(*a):
            with save_flash_outputs(cache):
                return fn(*a)

        out = checkpoint(run, *args, use_reentrant=False)
        cache.replay = True
        return out
    return checkpoint(fn, *args, use_reentrant=False)
