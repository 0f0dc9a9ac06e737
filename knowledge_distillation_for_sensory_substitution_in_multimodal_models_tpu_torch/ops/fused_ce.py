"""Fused (vocab-streaming) cross-entropy (port of the JAX package's
``ops/fused_ce.py``).

:func:`fused_ce_loss` (hidden [N, D], head w, labels [N]) is the mean CE
over ``labels != -100``; the caller applies the causal shift.
:func:`fused_ce_sum` returns the pre-reduction (sum of NLL, valid count).
``w_layout="dv"`` takes the head as [D, V]; ``"vd"`` as [V, D], the tied
embedding's own layout, whose gradient comes back in the same layout.

Underneath, :func:`lse_gold` gives each row's logsumexp and gold logit
through a ``torch.autograd.Function``:

* on a CUDA tensor, the hand-written kernels of ``csrc/fused_ce.cu`` on the
  Hopper vocab core of ``csrc/kdss_vocab_sm90.cuh``, with the grid and
  scratch of ``vocab_core.vocab_plan``: K5 (the forward, JAX
  ``_lse_gold_impl``: a sweep that keeps each row's online logsumexp and
  gold logit, then a combine of its partials) and K6 (the backward, JAX
  ``_lse_gold_bwd``: d_hidden and d_W, a sweep that writes the bf16
  d_logits ds [N, V] once, then dh = ds w and dW = ds^T h).  Neither reads
  a teacher, so V may be any size.  The kernels take the [V, D] layout; a
  "dv" head is transposed into it (a copy the tied 0.5B head never needs).
  The wrapper launches them or raises; nothing falls back;
* on a CPU tensor, the plain versions :func:`lse_gold_ref` and
  :func:`lse_gold_bwd_ref`, which compute logits per row chunk in float32
  and never hold more than one chunk's [rows, V] block.

Counters: ``lse_gold_fwd.launches`` (K5) and ``lse_gold_bwd.launches`` (K6,
one per backward: the ds sweep and the dh and dW products together).  CPU
calls never count.
"""

from __future__ import annotations

import torch

from .vocab_core import bwd_scratch as _bwd_scratch
from .vocab_core import fwd_scratch as _fwd_scratch

IGNORE = -100
# Rows per chunk of the plain versions: [512, 151936] f32 is 311 MB.
REF_CHUNK = 512
# Model dims the kernels are instantiated for: the 0.5B student's.
KERNEL_DIMS = (896,)
# Planes of K5's per-split partials: the partial logsumexp and gold logit.
_NPART = 2


def lse_gold_ref(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, chunk: int = REF_CHUNK):
    """Plain version of K5: (lse [N], gold [N]) f32 for a [V, D] head."""
    wf = w.float()
    lse, gold = [], []
    for i in range(0, h.shape[0], chunk):
        logits = h[i:i + chunk].float() @ wf.T
        lse.append(torch.logsumexp(logits, dim=-1))
        gold.append(logits.gather(1, labels[i:i + chunk, None].long())[:, 0])
    return torch.cat(lse), torch.cat(gold)


def lse_gold_bwd_ref(h, w, labels, lse, g_lse, g_gold, chunk: int = REF_CHUNK):
    """Plain version of K6: (dh, dw) for a [V, D] head from the cotangents
    of (lse, gold).  dlogits = g_lse * p + g_gold * onehot is rounded to h's
    dtype before the two products, as the kernels (and the JAX kernels) do;
    dh comes back in h's dtype, dw in w's."""
    wf = w.float()
    dh, dw = [], torch.zeros_like(wf)
    for i in range(0, h.shape[0], chunk):
        hc = h[i:i + chunk].float()
        p = torch.exp(hc @ wf.T - lse[i:i + chunk, None])
        dl = p * g_lse[i:i + chunk, None].float()
        dl.scatter_add_(1, labels[i:i + chunk, None].long(), g_gold[i:i + chunk, None].float())
        dl = dl.to(h.dtype).float()
        dh.append((dl @ wf).to(h.dtype))
        dw += dl.T @ hc
    return torch.cat(dh), dw.to(w.dtype)


def kernel_args(h, w, labels):
    """Check what the kernels take; raise ValueError on anything else."""
    if h.ndim != 2 or w.ndim != 2 or h.shape[1] != w.shape[1]:
        raise ValueError(f"need h [N, D] and w [V, D]; got {tuple(h.shape)}, {tuple(w.shape)}")
    if h.shape[1] not in KERNEL_DIMS:
        raise ValueError(f"model dim {h.shape[1]} not compiled (kernels have {KERNEL_DIMS})")
    for name, t in (("h", h), ("w", w)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if labels.shape != (h.shape[0],) or labels.dtype != torch.int32:
        raise ValueError("labels must be int32 [N]")
    for t in (w, labels):
        if t.device != h.device:
            raise ValueError(f"operands on {t.device} and {h.device}")
    if h.device.type != "cuda":
        raise ValueError(f"the fused CE kernels run on CUDA tensors, got {h.device}")


def lse_gold_fwd(h, w, labels):
    """K5 on CUDA, the plain version on the CPU."""
    if h.device.type == "cpu":
        return lse_gold_ref(h, w, labels)
    kernel_args(h, w, labels)
    from ._build import ce_fwd

    n, dev = h.shape[0], h.device
    part = _fwd_scratch(h, w, _NPART)
    lse = torch.empty(n, dtype=torch.float32, device=dev)
    gold = torch.empty(n, dtype=torch.float32, device=dev)
    ce_fwd(h, w, labels, part[0], part[1], lse, gold)
    lse_gold_fwd.launches += 1
    return lse, gold


def lse_gold_bwd(h, w, labels, lse, g_lse, g_gold):
    """K6 on CUDA, the plain version on the CPU."""
    if h.device.type == "cpu":
        return lse_gold_bwd_ref(h, w, labels, lse, g_lse, g_gold)
    for name, t in (("lse", lse), ("g_lse", g_lse), ("g_gold", g_gold)):
        if t.shape != h.shape[:1] or t.device != h.device:
            raise ValueError(f"{name} must be [N] on {h.device}")
    kernel_args(h, w, labels)
    from ._build import ce_bwd

    ds, part, nsplit = _bwd_scratch(h, w)
    dh, dw = torch.empty_like(h), torch.empty_like(w)
    f32 = lambda t: t.float().contiguous()  # noqa: E731
    ce_bwd(h, w, labels, f32(lse), f32(g_lse), f32(g_gold), ds, part, dh, dw, nsplit)
    lse_gold_bwd.launches += 1
    return dh, dw


WRAPPERS = (lse_gold_fwd, lse_gold_bwd)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


reset_launch_counts()


class _LseGold(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, labels):
        lse, gold = lse_gold_fwd(h, w, labels)
        ctx.save_for_backward(h, w, labels, lse)
        return lse, gold

    @staticmethod
    def backward(ctx, g_lse, g_gold):
        h, w, labels, lse = ctx.saved_tensors
        dh, dw = lse_gold_bwd(h, w, labels, lse, g_lse, g_gold)
        return dh, dw, None


def lse_gold(h: torch.Tensor, w_vd: torch.Tensor, labels: torch.Tensor):
    """(lse, gold) per row, differentiable in h and the [V, D] head."""
    if h.device.type == "cuda":
        h, w_vd = h.contiguous(), w_vd.contiguous()
        labels = labels.to(torch.int32).contiguous()
    return _LseGold.apply(h, w_vd, labels)


def fused_ce_sum(hidden: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, w_layout: str = "dv"):
    """(sum of NLL over valid rows, valid count): the pre-reduction CE."""
    if w_layout not in ("dv", "vd"):
        raise ValueError(f"w_layout must be 'dv' or 'vd', got {w_layout!r}")
    w_vd = w if w_layout == "vd" else w.T
    valid = labels != IGNORE
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    lse, gold = lse_gold(hidden, w_vd, safe)
    nll = (lse - gold) * valid
    return nll.sum(), valid.sum()


def fused_ce_loss(hidden: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, w_layout: str = "dv"):
    """Mean CE over ``labels != -100``; labels pre-shifted by the caller.

    hidden [N, D] (any float dtype), w [D, V] (or [V, D] with
    ``w_layout="vd"``), labels [N] int.  The result is f32.
    """
    nll_sum, count = fused_ce_sum(hidden, w, labels, w_layout=w_layout)
    return nll_sum / count.clamp(min=1)
