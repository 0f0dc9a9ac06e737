"""Loss primitives (port of the JAX package's ``losses/kd_losses.py``).

Ported so far: ``IGNORE_INDEX`` and :func:`masked_cross_entropy`
(`kd_losses.py:22-45`).  The KD losses (temperature KL, LoCa, NT-Xent,
OFA, feature MSE) come with the slices that train with a teacher
(ROADMAP.md, slices 3 and 4).
"""

from __future__ import annotations

import torch

IGNORE_INDEX = -100


def masked_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = IGNORE_INDEX
) -> torch.Tensor:
    """HF-style causal LM loss: shift by one, mean CE over labels != ignore.

    logits: [B, S, V] float; labels: [B, S] int.  Computed in f32.
    """
    shift_logits = logits[:, :-1, :].float()
    shift_labels = labels[:, 1:]
    mask = shift_labels != ignore_index
    safe = torch.where(mask, shift_labels, torch.zeros_like(shift_labels)).long()
    logz = torch.logsumexp(shift_logits, dim=-1)
    gold = shift_logits.gather(-1, safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / mask.sum().clamp(min=1)
