"""LoCa-KL over the vocabulary, alone or combined with cross-entropy (port
of the JAX package's ``ops/fused_loca.py``: ``fused_loca_ce_loss``,
``fused_loca_loss`` and ``fused_loca_sum``, in their single-device form with
the teacher logits materialized).

:func:`fused_loca_ce_loss` (student hidden [N, D], the student head [V, D],
the teacher-logit matrix ``tmat`` [N, V] f32 already scaled by 1/T and
truncated to the student vocab, the unshifted LoCa labels and the shifted
CE labels) returns (loca, ce): the paper-correct LoCa term
``kl_sum / (N * V) * T^2`` (N counts every row, padding and ignored rows
included) and the mean CE over the valid CE labels.  The caller builds
``tmat`` with one matrix product outside any kernel, as the JAX
``_materialize_t`` does; it is only read here, and lives from the forward
to the end of the backward.  :func:`fused_loca_loss` (the same operands
without the CE labels) returns the LoCa term alone, and
:func:`fused_loca_sum` its pre-reduction row sum.

Underneath, a ``torch.autograd.Function`` computes the per-row KL and CE
terms:

* on a CUDA tensor, the hand-written kernels of ``csrc/fused_loca_ce.cu``
  (K11): the forward (JAX ``_loca_ce_rows_kernels``: ``_stats_ce_kernel``
  and ``_klts_fwd_kernel``) and the backward (JAX ``_loca_ce_rows_bwd``:
  ``_dhs_ce_kernel`` and ``_dws_ce_kernel``).  The wrapper launches them or
  raises; nothing falls back;
* on a CPU tensor, the plain versions :func:`loca_ce_rows_ref` and
  :func:`loca_ce_rows_bwd_ref`, which compute logits per row chunk in
  float32 and never hold more than one chunk's [rows, V] block.

and another one the KL rows alone: K9 on CUDA (the same source, its
template flag CE off: JAX ``_row_stats`` and ``_call_rows`` with
``_kl_fwd_kernel`` forward, ``_tsum_kernel``, ``_dhs_kernel`` and
``_dws_kernel`` backward), :func:`loca_rows_ref` and
:func:`loca_rows_bwd_ref` on the CPU.

:func:`materialize_teacher_logits_int8` builds ``tmat`` from an int8
teacher head: the kernel of ``csrc/tmat_int8.cu`` (K10, the JAX
``_materialize_t_int8``) on CUDA, its plain version
:func:`materialize_teacher_logits_int8_ref` on the CPU.

The JAX package's TPU variants (the recompute form, bf16 and row-chunked
tmat, the fused single-sweep backward) are not carried over.

Counters: ``loca_ce_fwd.launches`` and ``loca_ce_bwd.launches`` (K11),
``loca_fwd.launches`` and ``loca_bwd.launches`` (K9), one per call (each
call launches its pass and combine kernels together), and
``materialize_teacher_logits_int8.launches``.  CPU calls never count.
"""

from __future__ import annotations

import math

import torch

from . import fused_kl
from .fused_ce import REF_CHUNK, _n_split

# Per-row statistics the forward hands to the backward, the rows of an f32
# [6, N] tensor (the order of the kernels' `Row` enum).
ROW_STATS = ("lse_sT", "lse_t", "scale", "tval", "lse_s1", "tsum")
# Planes of the forward's per-split scratch.
_NPART = 7


def _chunk_stats(s, t, lab, inv_t, alpha):
    """LoCa row statistics of one chunk from its f32 student logits s and
    teacher logits t (at 1/T), [rows, V]: (lse_sT, lse_t, scale, tval)."""
    lse_sT = torch.logsumexp(s * inv_t, dim=-1)
    lse_t = torch.logsumexp(t, dim=-1)
    valid = lab >= 0
    gold_t = torch.where(valid, t.gather(1, lab.clamp(min=0).long()[:, None])[:, 0],
                         torch.zeros_like(lse_t))
    m2 = torch.topk(t, 2, dim=-1).values[:, 1]  # a duplicated max gives m2 = m1
    p_gt, p_2nd = torch.exp(gold_t - lse_t), torch.exp(m2 - lse_t)
    scale = alpha / (1.0 - p_gt + p_2nd)
    tval = 1.0 - scale * (1.0 - p_gt)
    return lse_sT, lse_t, scale, tval


def _chunk_ce(s, lab_ce):
    """(lse_s1, CE rows) of one chunk from its f32 student logits s."""
    lse_s1 = torch.logsumexp(s, dim=-1)
    gold_s1 = s.gather(1, lab_ce.clamp(min=0).long()[:, None])[:, 0]
    return lse_s1, torch.where(lab_ce >= 0, lse_s1 - gold_s1, torch.zeros_like(lse_s1))


def _chunk_loca(s, t, lab, lse_sT, lse_t, scale, tval, inv_t):
    """(calibrated teacher probabilities, log p_sT) of one chunk."""
    p_t = torch.exp(t - lse_t[:, None])
    cols = torch.arange(s.shape[1], device=s.device)
    loca = torch.where(cols[None, :] == lab[:, None], tval[:, None], scale[:, None] * p_t)
    loca = torch.where((lab >= 0)[:, None], loca, p_t)  # ignored rows keep the raw teacher
    return loca, s * inv_t - lse_sT[:, None]


def _rows_ref(hs, ws, tmat, lab, lab_ce, inv_t, alpha, eps, chunk):
    """(kl [N], ce [N] or None, row stats [6, N]); without ``lab_ce`` (K9)
    no CE rows, and lse_s1 is 0 as the K9 kernels leave it."""
    wf = ws.float()
    log_eps = math.log(eps)
    kl, ce, stats = [], [], []
    for i in range(0, hs.shape[0], chunk):
        s = hs[i:i + chunk].float() @ wf.T
        t = tmat[i:i + chunk].float()
        lb = lab[i:i + chunk]
        lse_sT, lse_t, scale, tval = _chunk_stats(s, t, lb, inv_t, alpha)
        if lab_ce is None:
            lse_s1 = torch.zeros_like(lse_sT)
        else:
            lse_s1, ce_c = _chunk_ce(s, lab_ce[i:i + chunk])
            ce.append(ce_c)
        loca, log_ps = _chunk_loca(s, t, lb, lse_sT, lse_t, scale, tval, inv_t)
        pos = loca > 0
        log_loca = torch.log(torch.where(pos, loca, torch.ones_like(loca)))
        zero = torch.zeros_like(loca)
        kl.append(torch.where(pos, loca * (log_loca - log_ps.clamp(min=log_eps)), zero).sum(-1))
        tsum = torch.where(pos & (log_ps > log_eps), loca, zero).sum(-1)
        stats.append(torch.stack([lse_sT, lse_t, scale, tval, lse_s1, tsum]))
    return torch.cat(kl), torch.cat(ce) if ce else None, torch.cat(stats, dim=1)


def loca_ce_rows_ref(hs, ws, tmat, lab, lab_ce, *, inv_t: float, alpha: float, eps: float,
                     chunk: int = REF_CHUNK):
    """Plain version of the K11 forward: (kl [N], ce [N], row stats [6, N]),
    f32.  ``lab`` / ``lab_ce`` int [N] with -1 where ignored."""
    return _rows_ref(hs, ws, tmat, lab, lab_ce, inv_t, alpha, eps, chunk)


def loca_rows_ref(hs, ws, tmat, lab, *, inv_t: float, alpha: float, eps: float,
                  chunk: int = REF_CHUNK):
    """Plain version of the K9 forward (LoCa without CE): (kl [N], row stats
    [6, N] in K11's order, lse_s1 = 0), f32.  ``lab`` int [N], -1 where
    ignored."""
    kl, _, stats = _rows_ref(hs, ws, tmat, lab, None, inv_t, alpha, eps, chunk)
    return kl, stats


def _rows_bwd_ref(hs, ws, tmat, lab, lab_ce, stats, g_kl, g_ce, inv_t, eps, need_dw, chunk):
    """(dh, dw or None) from the KL rows' cotangent and, with ``lab_ce``, the
    CE rows'.  d_logits is rounded to h's dtype before the two products, as
    the kernels (and the JAX kernels) do; dh comes back in h's dtype, dw in
    w's."""
    wf = ws.float()
    log_eps = math.log(eps)
    dh, dw = [], torch.zeros_like(wf) if need_dw else None
    cols = torch.arange(ws.shape[0], device=ws.device)
    for i in range(0, hs.shape[0], chunk):
        hc = hs[i:i + chunk].float()
        s = hc @ wf.T
        t = tmat[i:i + chunk].float()
        lse_sT, lse_t, scale, tval, lse_s1, tsum = stats[:, i:i + chunk]
        lb = lab[i:i + chunk]
        loca, log_ps = _chunk_loca(s, t, lb, lse_sT, lse_t, scale, tval, inv_t)
        live = (log_ps > log_eps) & (loca > 0)
        gk = g_kl[i:i + chunk].float() * inv_t
        ds = (torch.exp(log_ps) * tsum[:, None] - torch.where(live, loca, torch.zeros_like(loca))) * gk[:, None]
        if lab_ce is not None:
            lc = lab_ce[i:i + chunk]
            gc = torch.where(lc >= 0, g_ce[i:i + chunk].float(), torch.zeros_like(gk))
            onehot = (cols[None, :] == lc[:, None]).float()
            ds = ds + (torch.exp(s - lse_s1[:, None]) - onehot) * gc[:, None]
        ds = ds.to(hs.dtype).float()
        dh.append((ds @ wf).to(hs.dtype))
        if need_dw:
            dw += ds.T @ hc
    return torch.cat(dh), None if dw is None else dw.to(ws.dtype)


def loca_ce_rows_bwd_ref(hs, ws, tmat, lab, lab_ce, stats, g_kl, g_ce, *, inv_t: float,
                         eps: float, chunk: int = REF_CHUNK):
    """Plain version of the K11 backward: (dh, dw) for a [V, D] head from the
    cotangents of the KL and CE rows (the JAX ``_combined_ds``)."""
    return _rows_bwd_ref(hs, ws, tmat, lab, lab_ce, stats, g_kl, g_ce, inv_t, eps, True, chunk)


def loca_rows_bwd_ref(hs, ws, tmat, lab, stats, g, *, inv_t: float, eps: float,
                      need_dw: bool = True, chunk: int = REF_CHUNK):
    """Plain version of the K9 backward: (dh, dw or None) for a [V, D] head
    from the cotangent ``g`` [N] of the KL rows (the ds of the JAX
    ``_dhs_kernel`` / ``_dws_kernel``)."""
    return _rows_bwd_ref(hs, ws, tmat, lab, None, stats, g, None, inv_t, eps, need_dw, chunk)


def kernel_args(hs, ws, tmat, *labels):
    """Check what the kernels take (the fused KL's operands, plus the label
    vectors); raise ValueError on anything else."""
    for t in labels:
        if t.shape != (hs.shape[0],) or t.dtype != torch.int32 or t.device != hs.device:
            raise ValueError(f"labels must be int32 [N] on {hs.device}")
    fused_kl.kernel_args(hs, ws, tmat)


def _check_stats(stats, n):
    if stats.shape != (len(ROW_STATS), n) or stats.dtype != torch.float32:
        raise ValueError("stats must be the forward's float32 [6, N]")


def loca_ce_fwd(hs, ws, tmat, lab, lab_ce, *, inv_t: float, alpha: float, eps: float):
    """K11 forward on CUDA, the plain version on the CPU: (kl, ce, stats)."""
    if hs.device.type == "cpu":
        return loca_ce_rows_ref(hs, ws, tmat, lab, lab_ce, inv_t=inv_t, alpha=alpha, eps=eps)
    kernel_args(hs, ws, tmat, lab, lab_ce)
    from ._build import loca_ce_fwd as launch

    n, dev = hs.shape[0], hs.device
    nsplit = _n_split(64, n, dev, blocks_per_sm=4)
    part = torch.empty(_NPART, nsplit, n, dtype=torch.float32, device=dev)
    stats = torch.empty(len(ROW_STATS), n, dtype=torch.float32, device=dev)
    kl = torch.empty(n, dtype=torch.float32, device=dev)
    ce = torch.empty(n, dtype=torch.float32, device=dev)
    launch(hs, ws, tmat, lab, lab_ce, part, stats, kl, ce, inv_t, alpha, math.log(eps))
    loca_ce_fwd.launches += 1
    return kl, ce, stats


def loca_ce_bwd(hs, ws, tmat, lab, lab_ce, stats, g_kl, g_ce, *, inv_t: float, eps: float):
    """K11 backward on CUDA, the plain version on the CPU: (dh, dw)."""
    if hs.device.type == "cpu":
        return loca_ce_rows_bwd_ref(hs, ws, tmat, lab, lab_ce, stats, g_kl, g_ce,
                                    inv_t=inv_t, eps=eps)
    kernel_args(hs, ws, tmat, lab, lab_ce)
    _check_stats(stats, hs.shape[0])
    from ._build import loca_ce_bwd as launch

    n, dev = hs.shape[0], hs.device
    nsplit = _n_split(32, n, dev, blocks_per_sm=2)
    part = torch.empty(nsplit, n, hs.shape[1], dtype=torch.float32, device=dev)
    dh, dw = torch.empty_like(hs), torch.empty_like(ws)
    f32 = lambda t: t.float().contiguous()  # noqa: E731
    launch(hs, ws, tmat, lab, lab_ce, stats.contiguous(), f32(g_kl), f32(g_ce), part, dh, dw,
           inv_t, math.log(eps))
    loca_ce_bwd.launches += 1
    return dh, dw


def loca_fwd(hs, ws, tmat, lab, *, inv_t: float, alpha: float, eps: float):
    """K9 forward on CUDA, the plain version on the CPU: (kl, stats)."""
    if hs.device.type == "cpu":
        return loca_rows_ref(hs, ws, tmat, lab, inv_t=inv_t, alpha=alpha, eps=eps)
    kernel_args(hs, ws, tmat, lab)
    from ._build import loca_fwd as launch

    n, dev = hs.shape[0], hs.device
    nsplit = _n_split(64, n, dev, blocks_per_sm=4)
    part = torch.empty(_NPART, nsplit, n, dtype=torch.float32, device=dev)
    stats = torch.empty(len(ROW_STATS), n, dtype=torch.float32, device=dev)
    kl = torch.empty(n, dtype=torch.float32, device=dev)
    launch(hs, ws, tmat, lab, part, stats, kl, inv_t, alpha, math.log(eps))
    loca_fwd.launches += 1
    return kl, stats


def loca_bwd(hs, ws, tmat, lab, stats, g, *, inv_t: float, eps: float, need_dw: bool = True):
    """K9 backward on CUDA, the plain version on the CPU: (dh, dw), dw None
    unless ``need_dw``."""
    if hs.device.type == "cpu":
        return loca_rows_bwd_ref(hs, ws, tmat, lab, stats, g, inv_t=inv_t, eps=eps, need_dw=need_dw)
    kernel_args(hs, ws, tmat, lab)
    _check_stats(stats, hs.shape[0])
    from ._build import loca_bwd as launch

    n, dev = hs.shape[0], hs.device
    nsplit = _n_split(32, n, dev, blocks_per_sm=2)
    part = torch.empty(nsplit, n, hs.shape[1], dtype=torch.float32, device=dev)
    dh = torch.empty_like(hs)
    dw = torch.empty_like(ws) if need_dw else None
    launch(hs, ws, tmat, lab, stats.contiguous(), g.float().contiguous(), part, dh, dw, inv_t,
           math.log(eps))
    loca_bwd.launches += 1
    return dh, dw


def materialize_teacher_logits_int8_ref(ht, wq, ws, inv_t: float, vocab: int):
    """Plain version of K10: f32 [N, vocab] = ((ht . bf(wq[:vocab])^T) * ws[:vocab])
    * inv_t, the int8 head cast exactly to ht's dtype and the product
    accumulated in f32 (the JAX ``_materialize_t`` with the int8 head)."""
    w = wq[:vocab].to(ht.dtype)
    t = ht @ w.T if ht.dtype == torch.float32 else torch.mm(ht, w.T, out_dtype=torch.float32)
    return t.mul_(ws[:vocab]).mul_(inv_t)


def materialize_teacher_logits_int8(ht, wq, ws, inv_t: float, vocab: int):
    """The teacher's logits at 1/T, truncated to the student's ``vocab``,
    from its final-norm hidden states ``ht`` [N, Dt] and its vocab-major int8
    head ``wq`` [Vt, Dt] with per-row scales ``ws`` [Vt]: f32 [N, vocab],
    the ``tmat`` of :func:`fused_loca_ce_loss` and ``fused_kl_loss``.  K10 on
    CUDA (reading the head's first ``vocab`` rows in place), the plain
    version on the CPU."""
    if not 0 < vocab <= wq.shape[0]:
        raise ValueError(f"vocab {vocab} must be in (0, {wq.shape[0]}]")
    if ht.device.type == "cpu":
        return materialize_teacher_logits_int8_ref(ht, wq, ws, inv_t, vocab)
    n, d = ht.shape
    if ht.dtype != torch.bfloat16 or not ht.is_contiguous():
        raise ValueError(f"ht must be contiguous bfloat16 [N, D], got {ht.dtype}")
    if wq.dtype != torch.int8 or wq.shape[1:] != (d,) or not wq.is_contiguous():
        raise ValueError(f"wq must be contiguous int8 [Vt, {d}], got {wq.dtype} {tuple(wq.shape)}")
    if ws.dtype != torch.float32 or ws.shape != wq.shape[:1] or not ws.is_contiguous():
        raise ValueError(f"ws must be contiguous float32 [{wq.shape[0]}]")
    if d % 16 or vocab % 2:
        raise ValueError(f"K10 takes D a multiple of 16 and an even vocab, got D={d}, vocab={vocab}")
    for t in (wq, ws):
        if t.device != ht.device:
            raise ValueError(f"operands on {t.device} and {ht.device}")
    from ._build import tmat_int8 as launch

    out = torch.empty(n, vocab, dtype=torch.float32, device=ht.device)
    launch(ht, wq[:vocab], ws[:vocab], out, inv_t)
    materialize_teacher_logits_int8.launches += 1
    return out


WRAPPERS = (loca_ce_fwd, loca_ce_bwd, loca_fwd, loca_bwd, materialize_teacher_logits_int8)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


reset_launch_counts()


class _LocaCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hs, ws, tmat, lab, lab_ce, inv_t, alpha, eps):
        kl, ce, stats = loca_ce_fwd(hs, ws, tmat, lab, lab_ce, inv_t=inv_t, alpha=alpha, eps=eps)
        ctx.save_for_backward(hs, ws, tmat, lab, lab_ce, stats)
        ctx.inv_t, ctx.eps = inv_t, eps
        return kl, ce

    @staticmethod
    def backward(ctx, g_kl, g_ce):
        hs, ws, tmat, lab, lab_ce, stats = ctx.saved_tensors
        dh, dw = loca_ce_bwd(hs, ws, tmat, lab, lab_ce, stats, g_kl, g_ce,
                             inv_t=ctx.inv_t, eps=ctx.eps)
        return dh, dw, None, None, None, None, None, None


class _Loca(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hs, ws, tmat, lab, inv_t, alpha, eps):
        kl, stats = loca_fwd(hs, ws, tmat, lab, inv_t=inv_t, alpha=alpha, eps=eps)
        ctx.save_for_backward(hs, ws, tmat, lab, stats)
        ctx.inv_t, ctx.eps = inv_t, eps
        return kl

    @staticmethod
    def backward(ctx, g):
        hs, ws, tmat, lab, stats = ctx.saved_tensors
        # a head that needs no gradient takes no dW sweep
        dh, dw = loca_bwd(hs, ws, tmat, lab, stats, g, inv_t=ctx.inv_t, eps=ctx.eps,
                          need_dw=ctx.needs_input_grad[1])
        return dh, dw, None, None, None, None, None


def _labels(lab):
    """int32 labels, every negative value as -1."""
    lab = torch.where(lab >= 0, lab, torch.full_like(lab, -1)).to(torch.int32)
    return lab.contiguous() if lab.device.type == "cuda" else lab


def _check_tmat(hs, ws_vd, tmat):
    n, v = hs.shape[0], ws_vd.shape[0]
    if tmat.shape != (n, v):
        raise ValueError(f"tmat must be [{n}, {v}] (truncated to the student vocab), got {tuple(tmat.shape)}")


def loca_ce_rows(hs, ws_vd, tmat, lab, lab_ce, *, inv_t: float, alpha: float, eps: float = 1e-8):
    """(kl rows, ce rows), differentiable in hs and the [V, D] head.  Labels
    < 0 are ignored (any negative value)."""
    if hs.device.type == "cuda":
        hs, ws_vd, tmat = hs.contiguous(), ws_vd.contiguous(), tmat.contiguous()
    return _LocaCE.apply(hs, ws_vd, tmat, _labels(lab), _labels(lab_ce), float(inv_t), float(alpha),
                         float(eps))


def loca_rows(hs, ws_vd, tmat, lab, *, inv_t: float, alpha: float, eps: float = 1e-8):
    """The LoCa-KL rows alone (K9), differentiable in hs and the [V, D] head.
    Labels < 0 are ignored (any negative value)."""
    if hs.device.type == "cuda":
        hs, ws_vd, tmat = hs.contiguous(), ws_vd.contiguous(), tmat.contiguous()
    return _Loca.apply(hs, ws_vd, tmat, _labels(lab), float(inv_t), float(alpha), float(eps))


def fused_loca_sum(hs, ws_vd, tmat, labels, *, temperature: float, alpha: float = 0.8,
                   eps: float = 1e-8):
    """Sum over rows of the calibrated-KL row sums (the pre-reduction LoCa
    of the JAX ``fused_loca_sum``), f32."""
    _check_tmat(hs, ws_vd, tmat)
    return loca_rows(hs, ws_vd, tmat, labels, inv_t=1.0 / temperature, alpha=alpha, eps=eps).sum()


def fused_loca_loss(hs, ws_vd, tmat, labels, *, temperature: float, alpha: float = 0.8,
                    eps: float = 1e-8):
    """The paper-correct LoCa KL, an f32 scalar: ``fused_loca_sum / (N * V) *
    T^2`` (torch's 'mean' reduction, N counting every row); the JAX
    ``fused_loca_loss`` contract with the head in its [V, D] layout, except
    that the teacher enters as its logits ``tmat`` [N, V] (f32, already at
    1/T), as in :func:`fused_loca_ce_loss`."""
    n, v = hs.shape[0], ws_vd.shape[0]
    total = fused_loca_sum(hs, ws_vd, tmat, labels, temperature=temperature, alpha=alpha, eps=eps)
    return total / (n * v) * temperature**2


def fused_loca_ce_loss(hs, ws_vd, tmat, loca_labels, ce_labels, *, temperature: float,
                       alpha: float, eps: float = 1e-8):
    """(LoCa loss, CE loss), f32 scalars; the JAX ``fused_loca_ce_loss``
    contract with ``student_head_layout="vd"``, except that the teacher
    enters as its logits ``tmat`` [N, V] (f32, already at 1/T)."""
    n, v = hs.shape[0], ws_vd.shape[0]
    _check_tmat(hs, ws_vd, tmat)
    kl, ce = loca_ce_rows(hs, ws_vd, tmat, loca_labels, ce_labels, inv_t=1.0 / temperature,
                          alpha=alpha, eps=eps)
    loca = kl.sum() / (n * v) * temperature**2
    count = (ce_labels >= 0).sum()
    return loca, ce.sum() / count.clamp(min=1)
