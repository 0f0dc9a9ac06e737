"""Row-chunked KD losses over the materialized teacher logits (port of the
JAX package's ``losses/chunked.py``).

Both functions take the student's final-norm hidden states flattened to
rows ``hidden`` [N, D] (N = B * S, b-major), its head in the stored [V, D]
layout, and the teacher's logits ``tmat`` [N, V], float32, already at 1/T
and truncated to the student vocab: the matrix the train step builds once
per micro-batch (``train/step.py::_teacher_logits``, K10 for an int8 head).
So the JAX scan's per-chunk teacher product (and its per-chunk dequantized
int8 head) has no counterpart here: there is one LoCa route, over ``tmat``.

Each chunk of rows computes its float32 student logits against a float32
copy of the head, made once per call, and runs under
``torch.utils.checkpoint``: the backward recomputes the chunk's logits
instead of keeping them, so at most one chunk's [rows, V] blocks live at a
time.

* :func:`chunked_kd_terms`: the masked CE, the temperature KL and the
  paper-correct LoCa term, each from the ``losses/kd_losses.py`` functions
  on the chunk (the plain autograd route, ``TrainConfig.ce_impl ==
  "chunked"``), with the reductions of the full-tensor functions.
* :func:`chunked_faithful_loca`: the reference-faithful LoCa (the JAX
  ``chunked_faithful_loca``), whose full-tensor column writes reduce to two
  [V] last-write tables, in two passes.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .kd_losses import (
    IGNORE_INDEX,
    _last_occurrence_column_values,
    kd_kl_loss,
    kl_elements,
    loca_loss,
    second_best,
)


def _logits(h: torch.Tensor, head_f: torch.Tensor) -> torch.Tensor:
    """float32 logits [rows, V] of hidden rows against the float32 head."""
    return h.float() @ head_f.T


def _chunk_terms(h, head_f, t, loca_lab, ce_lab, inv_t, alpha, need_ce, need_kl, need_loca):
    """(CE NLL sum, KL element sum, LoCa element sum) of one chunk; a term
    not asked for is 0."""
    s = _logits(h, head_f)
    zero = s.new_zeros(())
    ce = kl = loca = zero
    if need_ce:
        valid = ce_lab != IGNORE_INDEX
        gold = s.gather(1, torch.where(valid, ce_lab, 0).long()[:, None])[:, 0]
        ce = ((torch.logsumexp(s, dim=-1) - gold) * valid).sum()
    if need_kl or need_loca:
        st, el = (s * inv_t)[None], s.numel()
        # the means at T = 1 over logits already at 1/T, times the element
        # count: the chunk's element sums
        if need_kl:
            kl = kd_kl_loss(st, t[None], 1.0) * el
        if need_loca:
            loca = loca_loss(t[None], st, loca_lab[None], 1.0, alpha) * el
    return ce, kl, loca


def chunked_kd_terms(
    hidden: torch.Tensor,
    head: torch.Tensor,
    loca_labels: torch.Tensor,
    ce_labels: torch.Tensor,
    tmat: Optional[torch.Tensor] = None,
    *,
    temperature: float = 1.0,
    alpha: float = 0.8,
    chunk_size: int = 256,
    need_ce: bool = True,
    need_kl: bool = False,
    need_loca: bool = False,
) -> Dict[str, torch.Tensor]:
    """The requested terms as f32 scalars, under the keys "ce", "kl" and
    "loca": the mean CE over ``ce_labels != -100`` (labels already shifted
    by the caller), and the KL and LoCa terms with torch's 'mean' reduction
    over N * V elements, times T^2.  ``loca_labels`` are unshifted, < 0
    where ignored; ``tmat`` is needed for KL and LoCa."""
    n, v = hidden.shape[0], head.shape[0]
    if (need_kl or need_loca) and (tmat is None or tmat.shape != (n, v)):
        raise ValueError(f"the KL and LoCa terms need tmat [{n}, {v}]")
    head_f = head.float()
    sums = [hidden.new_zeros((), dtype=torch.float32) for _ in range(3)]
    for i in range(0, n, chunk_size):
        sl = slice(i, i + chunk_size)
        parts = checkpoint(_chunk_terms, hidden[sl], head_f, None if tmat is None else tmat[sl],
                           loca_labels[sl], ce_labels[sl], 1.0 / temperature, alpha, need_ce,
                           need_kl, need_loca, use_reentrant=False)
        sums = [a + b for a, b in zip(sums, parts)]
    ce_sum, kl_sum, loca_sum = sums
    out = {}
    if need_ce:
        out["ce"] = ce_sum / (ce_labels != IGNORE_INDEX).sum().clamp(min=1)
    if need_kl:
        out["kl"] = kl_sum / (n * v) * temperature**2
    if need_loca:
        out["loca"] = loca_sum / (n * v) * temperature**2
    return out


@torch.no_grad()
def _write_values(t: torch.Tensor, lab: torch.Tensor, alpha: float):
    """Per row of one chunk: (label id, label write value, second-best id,
    second-best write value, valid), from the teacher logits at 1/T, as
    ``loca_calibrated_probs`` computes them."""
    p_t = torch.softmax(t, dim=-1)
    valid = lab >= 0
    safe = torch.where(valid, lab, 0).long()
    p_gt = p_t.gather(-1, safe[:, None])[:, 0]
    k_idx = second_best(p_t)
    p_k = p_t.gather(-1, k_idx[:, None])[:, 0]
    sc = alpha / (1.0 - p_gt + p_k)
    return safe, 1.0 - sc * (p_t.sum(-1) - p_gt), k_idx, sc * p_k, valid


def _faithful_chunk(h, head_f, t, lbl_val, lbl_hit, k_val, k_hit, inv_t, eps):
    """One chunk's KL element sum against the column-written teacher."""
    log_p_s = torch.log(torch.clamp(torch.softmax(_logits(h, head_f) * inv_t, dim=-1), min=eps))
    out = torch.where(lbl_hit, lbl_val, torch.softmax(t, dim=-1))
    out = torch.where(k_hit, k_val, out)
    return kl_elements(out, log_p_s).sum()


def chunked_faithful_loca(
    hidden: torch.Tensor,
    head: torch.Tensor,
    labels: torch.Tensor,
    tmat: torch.Tensor,
    *,
    temperature: float = 1.0,
    alpha: float = 0.8,
    chunk_size: int = 256,
    eps: float = 1e-8,
) -> torch.Tensor:
    """The reference-faithful LoCa term, ``loca_loss(faithful_indexing=True)``
    of the full logits, without holding more than a chunk of rows of them.

    ``labels`` [N] are the unshifted LoCa labels in the rows' b-major order,
    < 0 where ignored.  Each label id and each second-best id writes its
    whole vocab column over every position, the last write in flat order
    winning; that global structure fits in two [V] tables of (last
    position, written value), so:

    * pass 1 (teacher only, no gradients): per chunk, each row's label and
      second-best ids and write values; then one ``scatter_reduce(amax)`` of
      the rows' global flat positions gives each column's last write
      (``kd_losses._last_occurrence_column_values``), b-major and s-minor
      as the reference writes.  An ignored label writes through id 0 unless
      no label is valid anywhere (the reference's quirk);
    * pass 2 (checkpointed, gradients to the student's hidden states and
      head): per chunk, the teacher probabilities with the label columns
      and then the second-best columns written over them, against the
      student's clamped log-probabilities.

    Returns the f32 scalar ``sum / (N * V) * T^2``."""
    n, v = hidden.shape[0], head.shape[0]
    if tmat.shape != (n, v):
        raise ValueError(f"tmat must be [{n}, {v}] (truncated to the student vocab), got {tuple(tmat.shape)}")
    parts = [_write_values(tmat[i:i + chunk_size], labels[i:i + chunk_size], alpha)
             for i in range(0, n, chunk_size)]
    lbl_idx, lbl_w, k_idx, k_w, valid = (torch.cat(p) for p in zip(*parts))
    lbl_val, lbl_hit = _last_occurrence_column_values(lbl_idx, lbl_w, v)
    lbl_hit = lbl_hit & valid.any()
    k_val, k_hit = _last_occurrence_column_values(k_idx, k_w, v)

    head_f = head.float()
    total = hidden.new_zeros((), dtype=torch.float32)
    for i in range(0, n, chunk_size):
        sl = slice(i, i + chunk_size)
        total = total + checkpoint(_faithful_chunk, hidden[sl], head_f, tmat[sl], lbl_val, lbl_hit,
                                   k_val, k_hit, 1.0 / temperature, eps, use_reentrant=False)
    return total / (n * v) * temperature**2

