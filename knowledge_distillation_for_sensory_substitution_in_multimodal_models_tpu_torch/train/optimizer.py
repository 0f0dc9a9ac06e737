"""Optimizer, LR schedule and phase-freeze masks (port of the JAX package's
``train/optimizer.py``).

* AdamW with torch's defaults (betas 0.9/0.999, eps 1e-8) and weight decay
  0.01: ``torch.optim.AdamW`` is the update optax's ``adamw`` matches
  (decoupled decay, bias-corrected moments).
* Float32 master weights: the JAX package keeps float32 parameters and
  computes in bf16 (flax ``param_dtype``).  Here the model holds the
  compute copy (bf16 on the card); each trainable parameter stored below
  float32 gets a float32 master, AdamW updates the master with float32
  moments (optax's ``mu_dtype=None`` on float32 params), and the parameter
  is set to the master cast to its dtype, once per step.  A float32
  parameter is its own master.  Without the master, an update below half
  a bf16 ulp (lr 2e-5 on a weight of magnitude 0.02) would round away.
* ``cosine_annealing_schedule``: torch ``CosineAnnealingLR`` (eta_min=0)
  stepped once per epoch, as a function of the update count.
* ``phase_trainable_mask``: double-trouble phase 1 freezes the language
  model, phase 2 the vision tower.  A frozen parameter is left out of the
  optimizer, so it gets no update and no decay (optax ``set_to_zero``), and
  is marked ``requires_grad=False``, so autograd computes no gradient for it
  (phase 1's frozen tied embedding takes no d_head sweep in the fused KL).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch


def cosine_annealing_schedule(base_lr: float, t_max: int, steps_per_epoch: int) -> Callable[[int], float]:
    """lr(step) = base * (1 + cos(pi * epoch / T_max)) / 2 with
    epoch = step // steps_per_epoch."""

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return base_lr * (1.0 + math.cos(math.pi * epoch / t_max)) / 2.0

    return schedule


def phase_trainable_mask(names, kd_mode: str, phase: int) -> Dict[str, bool]:
    """{parameter name: trainable} for the given mode/phase (names as in the
    student's ``named_parameters``, rooted at ``vision_tower`` /
    ``language_model`` / ...)."""

    def trainable(name: str) -> bool:
        if kd_mode != "double_trouble":
            return True
        root = name.split(".", 1)[0]
        if phase == 1:
            return root != "language_model"
        if phase == 2:
            return root != "vision_tower"
        return True

    return {n: trainable(n) for n in names}


class Optimizer:
    """AdamW over the float32 masters of a model's trainable parameters, with
    an optional schedule.  :meth:`apply` takes gradients by parameter name
    (the step's float32 carry, used as it is) and performs one update."""

    def __init__(self, params: Dict[str, torch.nn.Parameter], mask: Dict[str, bool],
                 learning_rate: float, schedule: Optional[Callable[[int], float]],
                 weight_decay: float, b1: float, b2: float, eps: float):
        self.params = {n: p for n, p in params.items() if mask[n]}
        for n, p in params.items():
            if not mask[n]:
                p.requires_grad_(False)
        self.masters = {n: p if p.dtype == torch.float32 else p.detach().float()
                        for n, p in self.params.items()}
        self.schedule = schedule
        self.count = 0  # updates applied, the schedule's argument
        self.opt = torch.optim.AdamW(list(self.masters.values()), lr=learning_rate,
                                     betas=(b1, b2), eps=eps, weight_decay=weight_decay)

    def _copy_to_params(self) -> None:
        for n, m in self.masters.items():
            if m is not self.params[n]:
                self.params[n].copy_(m)

    @torch.no_grad()
    def apply(self, grads: Dict[str, torch.Tensor]) -> None:
        if self.schedule is not None:
            for group in self.opt.param_groups:
                group["lr"] = self.schedule(self.count)
        for n, m in self.masters.items():
            m.grad = grads[n].float()
        self.opt.step()
        for m in self.masters.values():
            m.grad = None
        self._copy_to_params()
        self.count += 1

    def state_dict(self) -> dict:
        """AdamW's state, the update count and the masters of the parameters
        stored below float32 (the model's state_dict holds only their
        rounded copies)."""
        return {"adamw": self.opt.state_dict(), "count": self.count,
                "masters": {n: m for n, m in self.masters.items() if m is not self.params[n]}}

    @torch.no_grad()
    def load_masters(self, masters: Dict[str, torch.Tensor]) -> None:
        """Take the float32 masters of a checkpoint (by name) for a fresh
        optimizer; a parameter the checkpoint has no master for (a float32
        one, or one that was frozen) starts from its current weight.  AdamW's
        state and the update count stay fresh."""
        for n, m in self.masters.items():
            if m is not self.params[n]:
                m.copy_(masters[n] if n in masters else self.params[n])
        self._copy_to_params()

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        for n, m in state["masters"].items():
            self.masters[n].copy_(m)
        self._copy_to_params()
        self.opt.load_state_dict(state["adamw"])
        self.count = int(state["count"])


def make_optimizer(
    model: torch.nn.Module,
    learning_rate: float,
    *,
    weight_decay: float = 0.01,
    cosine_t_max: int = 0,
    steps_per_epoch: int = 1,
    kd_mode: str = "baseline",
    phase: int = 0,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> Optimizer:
    """AdamW (torch defaults) with optional cosine annealing and freeze mask
    over ``model``'s parameters."""
    params = dict(model.named_parameters())
    schedule = (cosine_annealing_schedule(learning_rate, cosine_t_max, steps_per_epoch)
                if cosine_t_max > 0 else None)
    mask = phase_trainable_mask(params, kd_mode, phase)
    return Optimizer(params, mask, learning_rate, schedule, weight_decay, b1, b2, eps)
