"""Loss primitives (port of the JAX package's ``losses/kd_losses.py``).

Ported so far: ``IGNORE_INDEX``, :func:`masked_cross_entropy`
(`kd_losses.py:22-45`); the temperature KL :func:`kd_kl_loss`
(`kd_losses.py:59-77`) and the paper-correct LoCa term with its helpers,
:func:`truncate_teacher_logits`, :func:`loca_calibrated_probs` and
:func:`loca_loss` (`kd_losses.py:48-191`), which every test of the fused
KL and LoCa + CE kernels holds them to; and the contrastive loss of phase 1
and feature_based, :func:`pool_and_normalize`, :func:`ntxent_loss` and
:func:`masked_ntxent_loss` (`kd_losses.py:194-266`), plain PyTorch as the
JAX package leaves it to XLA.  OFA and feature MSE are not ported.
Reductions follow torch's: ``F.kl_div(reduction='mean')`` divides by the
total element count (B*S*V).
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


def truncate_teacher_logits(teacher_logits: torch.Tensor, student_vocab: int) -> torch.Tensor:
    """Teacher/student vocab mismatch -> prefix truncation (the reference's
    ``teacher_logits[:, :, :student_logits.size(2)]``)."""
    return teacher_logits[..., :student_vocab]


def kd_kl_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
               temperature: float) -> torch.Tensor:
    """Temperature KL: mean over all elements of p_T (log p_T - log p_S),
    times T^2 (``F.kl_div(log_softmax(s / T), softmax(t / T),
    reduction='mean') * T**2``), the teacher truncated to the student vocab.
    Computed in f32."""
    teacher_logits = truncate_teacher_logits(teacher_logits, student_logits.shape[-1])
    log_p_t = torch.log_softmax(teacher_logits.float() / temperature, dim=-1)
    log_p_s = torch.log_softmax(student_logits.float() / temperature, dim=-1)
    kl = torch.exp(log_p_t) * (log_p_t - log_p_s)
    return kl.mean() * temperature**2


def loca_calibrated_probs(
    teacher_probs: torch.Tensor,
    labels: torch.Tensor,
    alpha: float,
    faithful_indexing: bool = False,
) -> torch.Tensor:
    """Paper-correct LoCa calibration of teacher probabilities [..., V].

    Per position: sigma = 1 / (1 - p_gt + p_2nd), s = alpha * sigma; every
    non-target probability is scaled by s and the target becomes
    1 - s * (sum_probs - p_gt).  p_2nd is the probability at the second
    index of ``topk(2)``, so a duplicated maximum gives p_2nd = p_max.
    Positions with labels < 0 keep the raw teacher distribution.

    ``faithful_indexing=True`` (the reference's full-tensor fancy-indexing
    writes) is not ported: it raises ``NotImplementedError``.
    """
    if faithful_indexing:
        raise NotImplementedError(
            "faithful_indexing (the reference's full-tensor LoCa writes) is not ported: "
            "ROADMAP.md queue 1 item 6")
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    p_gt = teacher_probs.gather(-1, safe[..., None])[..., 0]
    top2 = torch.topk(teacher_probs, 2, dim=-1).indices[..., 1]
    p_k = teacher_probs.gather(-1, top2[..., None])[..., 0]
    s = alpha / (1.0 - p_gt + p_k)
    target = 1.0 - s * (teacher_probs.sum(-1) - p_gt)
    vocab = teacher_probs.shape[-1]
    is_target = torch.arange(vocab, device=teacher_probs.device) == safe[..., None]
    out = torch.where(is_target, target[..., None], teacher_probs * s[..., None])
    return torch.where(valid[..., None], out, teacher_probs)


def loca_loss(
    teacher_logits: torch.Tensor,
    student_logits: torch.Tensor,
    labels: torch.Tensor,
    temperature: float,
    alpha: float = 0.8,
    faithful_indexing: bool = False,
    eps: float = 1e-8,
) -> torch.Tensor:
    """LoCa KD term: mean over all elements of KL(calibrated teacher ||
    student) at temperature T, times T^2.  The student side is
    ``log(clamp(softmax(s / T), eps))``, exactly as the reference; an element
    whose calibrated probability is not positive contributes 0."""
    teacher_logits = truncate_teacher_logits(teacher_logits, student_logits.shape[-1])
    p_t = torch.softmax(teacher_logits.float() / temperature, dim=-1)
    p_s = torch.softmax(student_logits.float() / temperature, dim=-1)
    log_p_s = torch.log(torch.clamp(p_s, min=eps))
    loca_t = loca_calibrated_probs(p_t, labels, alpha, faithful_indexing)
    pos = loca_t > 0
    safe_log = torch.log(torch.where(pos, loca_t, torch.ones_like(loca_t)))
    kl = torch.where(pos, loca_t * (safe_log - log_p_s), torch.zeros_like(loca_t))
    return kl.mean() * temperature**2


def _l2_normalize(x: torch.Tensor, eps: float = 1e-24) -> torch.Tensor:
    """L2 normalize with a gradient that is finite at x == 0: rsqrt of
    max(|x|^2, eps), so a padded, all-zero tile row has a flat gradient
    instead of the NaN of x / ||x||."""
    sq = (x * x).sum(dim=-1, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=eps))


def pool_and_normalize(features: torch.Tensor) -> torch.Tensor:
    """Mean-pool vision tokens, then L2-normalize: [B, T, D] -> [B, D]."""
    return _l2_normalize(features.mean(dim=1))


def _similarity(student_features, teacher_features, temperature):
    """Cosine similarities / temperature, [N, M] in f32 whatever the feature
    dtype (the features are normalized in their own dtype)."""
    s = _l2_normalize(student_features).float()
    t = _l2_normalize(teacher_features).float()
    return (s @ t.T) / temperature


def ntxent_loss(student_features: torch.Tensor, teacher_features: torch.Tensor,
                temperature: float = 0.07) -> torch.Tensor:
    """NT-Xent over in-batch pairs: CE of the similarity rows against the
    diagonal.  Identically zero at batch size 1, as in the reference."""
    log_probs = torch.log_softmax(_similarity(student_features, teacher_features, temperature), dim=-1)
    return -log_probs.diagonal().mean()


def masked_ntxent_loss(student_features: torch.Tensor, teacher_features: torch.Tensor,
                       valid: torch.Tensor, temperature: float = 0.07) -> torch.Tensor:
    """NT-Xent over a padded item axis (the anyres tiles): ``valid`` [N] bool
    masks padding out of the similarity columns (with the f32 minimum, not
    -inf) and out of the mean.  Features [N, D]."""
    logits = _similarity(student_features, teacher_features, temperature)
    logits = torch.where(valid[None, :], logits, torch.finfo(logits.dtype).min)
    diag = torch.log_softmax(logits, dim=-1).diagonal()
    n_valid = valid.sum().clamp(min=1)
    return -(torch.where(valid, diag, torch.zeros_like(diag)).sum() / n_valid)
