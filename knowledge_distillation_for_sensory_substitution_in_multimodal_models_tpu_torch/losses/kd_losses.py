"""Loss primitives (port of the JAX package's ``losses/kd_losses.py``, all
of it): ``IGNORE_INDEX``, :func:`masked_cross_entropy`; the temperature KL
:func:`kd_kl_loss`; the LoCa term with its helpers,
:func:`truncate_teacher_logits`, :func:`loca_calibrated_probs` and
:func:`loca_loss`, paper-correct or with the reference's faithful
full-tensor indexing, which the tests of the fused KL and LoCa kernels and
of ``losses/chunked.py`` hold them to; the contrastive loss of phase 1 and
feature_based, :func:`pool_and_normalize`, :func:`ntxent_loss` and
:func:`masked_ntxent_loss`; and :func:`ofa_loss`, :func:`feature_mse_loss`
and :func:`vision_phase1_loss`, which no train step calls.  Plain PyTorch,
as the JAX package leaves them to XLA.  Reductions follow torch's:
``F.kl_div(reduction='mean')`` divides by the total element count (B*S*V).
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


def _last_occurrence_column_values(indices: torch.Tensor, values: torch.Tensor, vocab: int):
    """For each vocab id v, the value at the LAST flat position where
    ``indices == v`` (torch advanced-indexing write order), and a hit mask:
    (values [vocab], hit [vocab] bool).  Deterministic: a scatter of the
    flat positions with ``amax``, then a gather."""
    flat_idx = indices.reshape(-1).long()
    pos = torch.arange(flat_idx.numel(), device=flat_idx.device)
    last = torch.full((vocab,), -1, dtype=torch.long, device=flat_idx.device)
    last = last.scatter_reduce(0, flat_idx, pos, reduce="amax")
    hit = last >= 0
    return values.reshape(-1)[last.clamp(min=0)], hit


def second_best(probs: torch.Tensor) -> torch.Tensor:
    """The index of the second entry of ``jax.lax.top_k(probs, 2)`` along the
    last axis: ties break to the lowest index, so a duplicated maximum gives
    its second occurrence.  (``torch.topk`` leaves the order of equal values
    unspecified on CUDA.)"""
    first = probs.argmax(dim=-1, keepdim=True)
    rest = probs.scatter(-1, first, float("-inf"))
    return rest.argmax(dim=-1)


def loca_calibrated_probs(
    teacher_probs: torch.Tensor,
    labels: torch.Tensor,
    alpha: float,
    faithful_indexing: bool = False,
) -> torch.Tensor:
    """LoCa calibration of teacher probabilities [..., V].

    Per position: sigma = 1 / (1 - p_gt + p_2nd), s = alpha * sigma; the
    target becomes 1 - s * (sum_probs - p_gt) and the second-best s * p_2nd.
    p_2nd is the probability at the second index of top-2, so a duplicated
    maximum gives p_2nd = p_max.

    ``faithful_indexing=False`` (the default, paper-correct): per position,
    every non-target probability is scaled by s, so the calibrated
    distribution sums to 1; positions with labels < 0 keep the raw teacher
    distribution.  ``True`` replicates the reference's full-tensor fancy
    indexing: each label id and each second-best id writes its WHOLE vocab
    column across every position, the last write in row-major flat order
    winning, the second-best writes after the label writes; an ignored
    label writes through id 0, unless no label of a [B, S] batch is valid.
    """
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    p_gt = teacher_probs.gather(-1, safe[..., None])[..., 0]
    top2 = second_best(teacher_probs)
    p_k = teacher_probs.gather(-1, top2[..., None])[..., 0]
    s = alpha / (1.0 - p_gt + p_k)
    target = 1.0 - s * (teacher_probs.sum(-1) - p_gt)
    vocab = teacher_probs.shape[-1]
    if faithful_indexing:
        lbl_cols, lbl_hit = _last_occurrence_column_values(safe, target, vocab)
        if labels.ndim == 2:  # an all-ignore batch writes no label column
            lbl_hit = lbl_hit & valid.any()
        k_cols, k_hit = _last_occurrence_column_values(top2, s * p_k, vocab)
        out = torch.where(lbl_hit, lbl_cols, teacher_probs)
        return torch.where(k_hit, k_cols, out)
    is_target = torch.arange(vocab, device=teacher_probs.device) == safe[..., None]
    out = torch.where(is_target, target[..., None], teacher_probs * s[..., None])
    return torch.where(valid[..., None], out, teacher_probs)


def kl_elements(target: torch.Tensor, log_q: torch.Tensor) -> torch.Tensor:
    """torch ``F.kl_div(log_q, target)`` pointwise: target (log target -
    log_q), 0 where target is not positive."""
    pos = target > 0
    safe_log = torch.log(torch.where(pos, target, torch.ones_like(target)))
    return torch.where(pos, target * (safe_log - log_q), torch.zeros_like(target))


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
    return kl_elements(loca_t, log_p_s).mean() * temperature**2


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


def ofa_loss(teacher_logits: torch.Tensor, student_logits: torch.Tensor, temperature: float,
             gamma: float = 2.0) -> torch.Tensor:
    """OFA focal-style KD: mean of -(1 + max_v p_T)^gamma * log_softmax(s / T).
    As in the reference, the teacher is not truncated to the student vocab
    (its max broadcasts over the student's).  Computed in f32."""
    p_t = torch.softmax(teacher_logits.float() / temperature, dim=-1)
    pt_target = p_t.max(dim=-1, keepdim=True).values
    log_p_s = torch.log_softmax(student_logits.float() / temperature, dim=-1)
    return (-((1.0 + pt_target) ** gamma) * log_p_s).mean()


def feature_mse_loss(student_features: torch.Tensor, teacher_features: torch.Tensor) -> torch.Tensor:
    """MSE between (already pooled and normalized) feature vectors."""
    return ((student_features - teacher_features) ** 2).mean()


def vision_phase1_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                       student_features: torch.Tensor, teacher_features: torch.Tensor,
                       temperature: float, soft_target_weight: float = 0.1,
                       contrastive_weight: float = 0.5, ntxent_temperature: float = 0.07) -> torch.Tensor:
    """The double-trouble phase-1 loss on dense tensors: w_kl * KL(T) + w_c *
    NT-Xent over pooled vision features."""
    kl = kd_kl_loss(student_logits, teacher_logits, temperature)
    con = ntxent_loss(student_features, teacher_features, ntxent_temperature)
    return soft_target_weight * kl + contrastive_weight * con
