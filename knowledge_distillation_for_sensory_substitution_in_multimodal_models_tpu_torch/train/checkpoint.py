"""Checkpoints with the reference's filename and resume conventions (port of
the JAX package's ``train/checkpoint.py``, which saves with Orbax).

* a checkpoint carries its validation loss in its name
  (``epoch=NN-val_loss=X.XXXX.ckpt``);
* resume loads the LOWEST val_loss in the directory;
* ``save_top_k=1``: the older checkpoint is removed on improvement;
* ``preempt-step=N.ckpt`` is an unconditional snapshot outside that policy;
* a params-only restore starts a later double-trouble phase from the
  previous phase's best checkpoint (``restore_params``), or loads the
  weights into a bare model for serving and evaluation
  (``restore_model``).

Each checkpoint is one ``torch.save`` file of {params (the student's
state_dict), opt_state, step}.  The three name helpers are copies of the
JAX module's (it imports orbax at its top, so it is not imported here).

A student sharded over a mesh (FSDP2 / DTensor) is written in the same
format: :func:`gather_full_state` gathers the full, unsharded weights and
AdamW state to rank 0 (``torch.distributed.checkpoint.state_dict`` with
``full_state_dict=True``), so a checkpoint written by N ranks restores in
one process (the evaluator, ``--student_ckpt_path``, the phase hand-off).
The other way, :meth:`CheckpointManager.restore_weights` loads a
checkpoint's float32 weights into the unsharded model before it is
sharded, and :func:`load_sharded_optimizer` AdamW's state after.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Tuple

import torch

_VAL_RE = re.compile(r"val_loss=([\d.]+?)\.ckpt")


def checkpoint_name(epoch: int, val_loss: float) -> str:
    return f"epoch={epoch:02d}-val_loss={val_loss:.4f}.ckpt"


def extract_val_loss(filename: str) -> float:
    """inf when the name carries no val_loss."""
    m = _VAL_RE.search(filename)
    return float(m.group(1)) if m else float("inf")


def find_best_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Lowest-val_loss checkpoint path, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    names = [n for n in os.listdir(ckpt_dir) if n.endswith(".ckpt")]
    if not names:
        return None
    return os.path.join(ckpt_dir, min(names, key=extract_val_loss))


def _save(path: str, state: Any) -> None:
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    """save_top_k=1 manager over ``torch.save`` files."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.ckpt_dir, exist_ok=True)

    def improves(self, val_loss: float) -> bool:
        """Whether :meth:`save` would write ``val_loss`` (it beats the best)."""
        prev = find_best_checkpoint(self.ckpt_dir)
        return prev is None or extract_val_loss(prev) > val_loss

    def save(self, epoch: int, val_loss: float, state: Any) -> Optional[str]:
        """Save if val_loss improves on the best existing; prune the old."""
        if not self.improves(val_loss):
            return None
        prev = find_best_checkpoint(self.ckpt_dir)
        path = os.path.join(self.ckpt_dir, checkpoint_name(epoch, val_loss))
        _save(path, state)
        if prev is not None and os.path.abspath(prev) != path:  # a resumed run can
            os.remove(prev)  # land on the same epoch and rounded val_loss
        return path

    def save_preempt(self, step: int, state: Any) -> str:
        """Unconditional snapshot outside the top-k policy (preemption)."""
        path = os.path.join(self.ckpt_dir, f"preempt-step={step}.ckpt")
        _save(path, state)
        return path

    def restore_best(self, map_location=None) -> Tuple[Optional[Any], Optional[str]]:
        path = find_best_checkpoint(self.ckpt_dir)
        if path is None:
            return None, None
        return self.restore(path, map_location), path

    def restore(self, path: str, map_location=None) -> Any:
        return torch.load(os.path.abspath(path), map_location=map_location, weights_only=True)

    def restore_model(self, path: str, model: torch.nn.Module, map_location=None) -> torch.nn.Module:
        """Params-only restore into a bare model (the evaluator's and the
        inference CLI's ``--student_ckpt_path``; the JAX CLIs'
        ``restore(..., partial=True)``): the checkpoint's weights into
        ``model``, cast to its dtype; the optimizer state is not read.
        Returns ``model``."""
        model.load_state_dict(self.restore(path, map_location)["params"])
        return model

    def restore_weights(self, path: str, model: torch.nn.Module, map_location=None) -> torch.nn.Module:
        """The checkpoint's weights at full precision into an unsharded
        ``model`` (its float32 masters where it has them, else its params,
        cast to the model's dtype); the optimizer state is not read.  The
        mesh paths load a checkpoint so before ``parallel.shard_params``."""
        saved = self.restore(path, map_location)
        model.load_state_dict({**saved["params"], **saved["opt_state"]["masters"]})
        return model

    def restore_params(self, path: str, state, map_location=None):
        """Params-only restore (the JAX ``restore(..., partial=True)``), for
        the phase hand-off: the checkpoint's weights into ``state``'s fresh
        model and its float32 masters into ``state``'s fresh optimizer;
        AdamW's moments and the step count start anew.  Returns ``state``."""
        saved = self.restore(path, map_location)
        state.model.load_state_dict(saved["params"])
        state.optimizer.load_masters(saved["opt_state"]["masters"])
        return state


def gather_full_state(state, compute_dtype: Optional[torch.dtype]) -> Optional[Dict[str, Any]]:
    """The checkpoint of a sharded ``TrainState`` (FSDP2 parameters, which
    are their own float32 masters) in the single-process format: params in
    ``compute_dtype``, the float32 masters of the trainable ones when
    ``compute_dtype`` is below float32, AdamW's state keyed by the
    optimizer's parameter order.  Collective: every rank calls it; rank 0
    gets the dict (in host memory), the others None."""
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions,
        get_model_state_dict,
        get_optimizer_state_dict,
    )

    opts = StateDictOptions(full_state_dict=True, cpu_offload=True)
    sd = get_model_state_dict(state.model, options=opts)
    osd = get_optimizer_state_dict(state.model, state.optimizer.opt, options=opts)
    from ..parallel.mesh import is_rank0

    if not is_rank0():
        return None
    dtype = compute_dtype or torch.float32
    index = {n: i for i, n in enumerate(state.optimizer.masters)}
    adamw = {"state": {index[k]: v for k, v in osd["state"].items()},
             "param_groups": [dict(g, params=[index[n] for n in g["params"]]) for g in osd["param_groups"]]}
    masters = {n: sd[n] for n in index} if dtype != torch.float32 else {}
    return {"params": {n: t.to(dtype) for n, t in sd.items()},
            "opt_state": {"adamw": adamw, "count": state.optimizer.count, "masters": masters},
            "step": state.step}


def load_sharded_optimizer(state, saved: Dict[str, Any]) -> None:
    """A checkpoint's AdamW state and update count into the optimizer of a
    sharded ``TrainState`` (every rank, after ``shard_params``; the weights
    went in before, by :meth:`CheckpointManager.restore_weights`)."""
    from torch.distributed.checkpoint.state_dict import StateDictOptions, set_optimizer_state_dict

    names = list(state.optimizer.masters)
    adamw = saved["opt_state"]["adamw"]
    osd = {"state": {names[i]: v for i, v in adamw["state"].items()},
           "param_groups": [dict(g, params=[names[i] for i in g["params"]]) for g in adamw["param_groups"]]}
    set_optimizer_state_dict(state.model, state.optimizer.opt, osd,
                             options=StateDictOptions(full_state_dict=True))
    state.optimizer.count = int(saved["opt_state"]["count"])
    state.step = int(saved["step"])
