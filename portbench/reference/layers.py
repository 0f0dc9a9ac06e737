"""The plain float32 operations that the reference's towers and language
models share: named weights, the linear product (in float8 e4m3 for the
control), grouped-head attention, RMSNorm, and a layer run under
``torch.utils.checkpoint``."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint


class Weights:
    """Named parameters: float32 leaves that train, and frozen tensors in
    any dtype, widened to float32 where they are read."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        self.t = tensors

    def __call__(self, name: str) -> torch.Tensor:
        x = self.t[name]
        return x if x.dtype == torch.float32 else x.float()


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x.detach())


def linear(x, w, b=None, precision="float32"):
    if precision == "fp8":
        x, w = _fp8(x), _fp8(w)
    y = x @ w.T
    return y if b is None else y + b


def attention(q, k, v, allowed: Optional[torch.Tensor]):
    """q [H, S, d], k, v [Hkv, S, d] (heads grouped as HF's repeat_kv)."""
    rep = q.shape[0] // k.shape[0]
    k, v = k.repeat_interleave(rep, dim=0), v.repeat_interleave(rep, dim=0)
    scores = (q @ k.transpose(1, 2)) * q.shape[-1] ** -0.5
    if allowed is not None:
        scores = scores.masked_fill(~allowed, float("-inf"))
    return torch.softmax(scores, dim=-1) @ v


def checkpointed(fn, *args, ckpt: bool):
    return checkpoint(fn, *args, use_reentrant=False) if ckpt else fn(*args)


def rms_norm(x, w, eps):
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))
