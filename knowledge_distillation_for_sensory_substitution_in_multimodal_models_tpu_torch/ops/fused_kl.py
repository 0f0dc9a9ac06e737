"""Fused temperature KL over the vocabulary (port of the JAX package's
``ops/fused_kl.py::fused_kl_loss`` in its single-device form, with the
student head in its [V, D] layout and the teacher logits materialized).

:func:`fused_kl_loss` (student hidden [N, D], the student head [V, D], the
teacher-logit matrix ``tmat`` [N, V] f32 already scaled by 1/T and
truncated to the student vocab) returns ``sum_rows KL_row / (N * V) * T^2``
with KL_row = sum_v p_t (log p_t - log p_sT), N counting every row
(padding included): the JAX ``fused_kl_loss`` contract with
``student_head_layout="vd"``, except that the teacher enters as ``tmat``, as
in ``fused_loca.fused_loca_ce_loss``.  The caller builds ``tmat`` with one
matrix product outside any kernel (``train/step.py::_teacher_logits``).

Underneath, a ``torch.autograd.Function`` computes the per-row KL:

* on a CUDA tensor, the hand-written kernels of ``csrc/fused_kl.cu`` on the
  Hopper vocab core of ``csrc/kdss_vocab_sm90.cuh``, with the grid and
  scratch of ``vocab_core.vocab_plan``: K7 (the forward, JAX
  ``_kl_rows_impl``: one sweep that keeps each row's student and teacher
  statistics, then a combine of its partials into the KL rows and the
  student's and the teacher's lse at 1/T) and K8 (the backward, JAX
  ``_kl_rows_bwd``: a sweep that writes the bf16 d_logits ds [N, V] once,
  then d_hidden = ds w and, only where the head needs a gradient, d_head =
  ds^T h).  The kernels take V a multiple of 4 (tmat read in 8-byte
  pairs).  The wrappers launch them or raise; nothing falls back;
* on a CPU tensor, the plain versions :func:`kl_rows_ref` and
  :func:`kl_rows_bwd_ref`, which compute logits per row chunk in float32 and
  never hold more than one chunk's [rows, V] block.

Counters: ``kl_fwd.launches`` (K7, its sweep and combine kernels),
``kl_bwd.launches`` (K8's ds sweep, dh product and its reduction) and
``kl_bwd.dw_launches`` (K8's dW product, skipped for a head that needs no
gradient, such as phase 1's frozen tied embedding).  CPU calls never count.
"""

from __future__ import annotations

import torch

from .fused_ce import REF_CHUNK, KERNEL_DIMS
from .vocab_core import bwd_scratch as _bwd_scratch
from .vocab_core import fwd_scratch as _fwd_scratch

# Planes of the forward's per-split scratch: the student's (max, sum) at 1/T
# and the teacher's (max, Zt, U, W).
_NPART = 6


def kl_rows_ref(hs, ws, tmat, *, inv_t: float, chunk: int = REF_CHUNK):
    """Plain version of K7: (kl [N], lse_s [N], lse_t [N]), f32; lse_s is the
    student's logsumexp at 1/T, lse_t the teacher's (``tmat`` is at 1/T)."""
    wf = ws.float()
    kl, lse_s, lse_t = [], [], []
    for i in range(0, hs.shape[0], chunk):
        s = (hs[i:i + chunk].float() @ wf.T) * inv_t
        t = tmat[i:i + chunk].float()
        ls, lt = torch.logsumexp(s, dim=-1), torch.logsumexp(t, dim=-1)
        log_pt = t - lt[:, None]
        kl.append((torch.exp(log_pt) * (log_pt - s + ls[:, None])).sum(-1))
        lse_s.append(ls)
        lse_t.append(lt)
    return torch.cat(kl), torch.cat(lse_s), torch.cat(lse_t)


def kl_rows_bwd_ref(hs, ws, tmat, lse_s, lse_t, g, *, inv_t: float, need_dw: bool = True,
                    chunk: int = REF_CHUNK):
    """Plain version of K8: (dh, dw or None) for a [V, D] head from the
    cotangent ``g`` [N] of the KL rows.  ds = (p_sT - p_t) g / T is rounded to
    h's dtype before the two products, as the kernels (and the JAX kernels)
    do; dh comes back in h's dtype, dw in w's."""
    wf = ws.float()
    dh, dw = [], torch.zeros_like(wf) if need_dw else None
    for i in range(0, hs.shape[0], chunk):
        hc = hs[i:i + chunk].float()
        s = (hc @ wf.T) * inv_t
        p_s = torch.exp(s - lse_s[i:i + chunk, None])
        p_t = torch.exp(tmat[i:i + chunk].float() - lse_t[i:i + chunk, None])
        ds = ((p_s - p_t) * g[i:i + chunk, None].float() * inv_t).to(hs.dtype).float()
        dh.append((ds @ wf).to(hs.dtype))
        if need_dw:
            dw += ds.T @ hc
    return torch.cat(dh), None if dw is None else dw.to(ws.dtype)


def kernel_args(hs, ws, tmat):
    """Check what the kernels take; raise ValueError on anything else."""
    if hs.ndim != 2 or ws.ndim != 2 or hs.shape[1] != ws.shape[1]:
        raise ValueError(f"need hs [N, D] and ws [V, D]; got {tuple(hs.shape)}, {tuple(ws.shape)}")
    if hs.shape[1] not in KERNEL_DIMS:
        raise ValueError(f"model dim {hs.shape[1]} not compiled (kernels have {KERNEL_DIMS})")
    for name, t in (("hs", hs), ("ws", ws)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n, v = hs.shape[0], ws.shape[0]
    if tmat.shape != (n, v) or tmat.dtype != torch.float32 or not tmat.is_contiguous():
        raise ValueError(f"tmat must be contiguous float32 [{n}, {v}], got {tuple(tmat.shape)} {tmat.dtype}")
    for t in (ws, tmat):
        if t.device != hs.device:
            raise ValueError(f"operands on {t.device} and {hs.device}")
    if hs.device.type != "cuda":
        raise ValueError(f"the fused loss kernels run on CUDA tensors, got {hs.device}")
    if v % 4:
        raise ValueError(f"the kernels take V a multiple of 4 (tmat read in 8-byte pairs), got V={v}")


def kl_fwd(hs, ws, tmat, *, inv_t: float):
    """K7 on CUDA, the plain version on the CPU: (kl, lse_s, lse_t)."""
    if hs.device.type == "cpu":
        return kl_rows_ref(hs, ws, tmat, inv_t=inv_t)
    kernel_args(hs, ws, tmat)
    from ._build import kl_fwd as launch

    n, dev = hs.shape[0], hs.device
    part = _fwd_scratch(hs, ws, _NPART)
    kl, lse_s, lse_t = (torch.empty(n, dtype=torch.float32, device=dev) for _ in range(3))
    launch(hs, ws, tmat, part, kl, lse_s, lse_t, inv_t)
    kl_fwd.launches += 1
    return kl, lse_s, lse_t


def kl_bwd(hs, ws, tmat, lse_s, lse_t, g, *, inv_t: float, need_dw: bool = True):
    """K8 on CUDA, the plain version on the CPU: (dh, dw), dw None unless
    ``need_dw``."""
    if hs.device.type == "cpu":
        return kl_rows_bwd_ref(hs, ws, tmat, lse_s, lse_t, g, inv_t=inv_t, need_dw=need_dw)
    for name, t in (("lse_s", lse_s), ("lse_t", lse_t)):
        if t.shape != hs.shape[:1] or t.dtype != torch.float32:
            raise ValueError(f"{name} must be the forward's float32 [N]")
    if g.shape != hs.shape[:1] or g.device != hs.device:
        raise ValueError(f"g must be [N] on {hs.device}")
    kernel_args(hs, ws, tmat)
    from ._build import kl_bwd as launch

    ds, part, nsplit = _bwd_scratch(hs, ws)
    dh = torch.empty_like(hs)
    dw = torch.empty_like(ws) if need_dw else None
    launch(hs, ws, tmat, lse_s.contiguous(), lse_t.contiguous(), g.float().contiguous(), ds, part, dh, dw,
           nsplit, inv_t)
    kl_bwd.launches += 1
    kl_bwd.dw_launches += int(need_dw)
    return dh, dw


def reset_launch_counts() -> None:
    kl_fwd.launches = 0
    kl_bwd.launches = kl_bwd.dw_launches = 0


reset_launch_counts()


class _KL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hs, ws, tmat, inv_t):
        kl, lse_s, lse_t = kl_fwd(hs, ws, tmat, inv_t=inv_t)
        ctx.save_for_backward(hs, ws, tmat, lse_s, lse_t)
        ctx.inv_t = inv_t
        return kl

    @staticmethod
    def backward(ctx, g):
        hs, ws, tmat, lse_s, lse_t = ctx.saved_tensors
        # a frozen head (phase 1's tied embedding) takes no dW sweep
        dh, dw = kl_bwd(hs, ws, tmat, lse_s, lse_t, g, inv_t=ctx.inv_t,
                        need_dw=ctx.needs_input_grad[1])
        return dh, dw, None, None


def kl_rows(hs, ws_vd, tmat, *, inv_t: float):
    """KL rows [N] f32, differentiable in hs and the [V, D] head."""
    if hs.device.type == "cuda":
        hs, ws_vd, tmat = hs.contiguous(), ws_vd.contiguous(), tmat.contiguous()
    return _KL.apply(hs, ws_vd, tmat, float(inv_t))


def fused_kl_loss(hs, ws_vd, tmat, *, temperature: float):
    """The temperature KL, an f32 scalar: sum of the KL rows / (N * V) * T^2."""
    n, v = hs.shape[0], ws_vd.shape[0]
    if tmat.shape != (n, v):
        raise ValueError(f"tmat must be [{n}, {v}] (truncated to the student vocab), got {tuple(tmat.shape)}")
    kl = kl_rows(hs, ws_vd, tmat, inv_t=1.0 / temperature)
    return kl.sum() / (n * v) * temperature**2
