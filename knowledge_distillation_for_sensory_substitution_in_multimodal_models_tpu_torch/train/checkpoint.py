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
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional, Tuple

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

    def save(self, epoch: int, val_loss: float, state: Any) -> Optional[str]:
        """Save if val_loss improves on the best existing; prune the old."""
        prev = find_best_checkpoint(self.ckpt_dir)
        if prev is not None and extract_val_loss(prev) <= val_loss:
            return None
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

    def restore_params(self, path: str, state, map_location=None):
        """Params-only restore (the JAX ``restore(..., partial=True)``), for
        the phase hand-off: the checkpoint's weights into ``state``'s fresh
        model and its float32 masters into ``state``'s fresh optimizer;
        AdamW's moments and the step count start anew.  Returns ``state``."""
        saved = self.restore(path, map_location)
        state.model.load_state_dict(saved["params"])
        state.optimizer.load_masters(saved["opt_state"]["masters"])
        return state
