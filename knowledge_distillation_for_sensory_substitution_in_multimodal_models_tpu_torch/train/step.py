"""The train step: teacher forward (no grad), student forward/backward, the
mode-dispatched loss and gradient accumulation (port of the JAX package's
``train/step.py``).

The JAX step is one jitted program with a ``lax.scan`` over the
accumulation axis; here it is an eager loop over that axis, with the same
arithmetic: micro-batch gradients are summed into a float32 carry (or
carried as a running mean in bf16 / the param dtype, ``accum_dtype``),
divided by A, and applied in one optimizer update to the float32 master
weights (``optimizer.py``), which the bf16 model then copies.  Gradients are taken
with ``torch.autograd.grad``, not accumulated in ``.grad`` (which would sum
in the bf16 parameter dtype).

Every mode of the JAX step is ported (`step.py:282-301`):

* ``baseline``: the student alone, masked CE;
* ``logit_based`` and ``double_trouble`` phase 2: LoCa + CE; phase 3:
  gamma * (LoCa + CE) + (1 - gamma) * CE;
* ``double_trouble`` phase 1: w_kl * KL + w_c * NT-Xent; ``feature_based``:
  w_kl * KL + w_ce * CE + w_c * NT-Xent.  NT-Xent runs over the per-tile
  vision features of both towers (plain PyTorch, as the JAX package leaves
  it to XLA).

``TrainConfig.ce_impl`` picks the route of the vocabulary terms, as in the
JAX step: ``"fused"`` streams the vocabulary through the kernels (CE through
``ops/fused_ce.py``, the temperature KL through ``ops/fused_kl.py``, LoCa +
CE through one combined pipeline, ``ops/fused_loca.py``); ``"chunked"`` is
the plain autograd route on any device, per row chunk of float32 logits
(``losses/chunked.py::chunked_kd_terms``), for what the kernels do not take
(a width other than 896).  ``loss.loca_faithful_indexing`` takes LoCa from
``losses/chunked.py::chunked_faithful_loca`` (the reference's full-tensor
column writes), whatever ``ce_impl``; CE then takes ``ce_impl``'s route.

The frozen teacher runs under ``torch.no_grad()`` on the RGB stream (the
``teacher_*`` batch keys), once per micro-batch; its logits at 1/T,
truncated to the student vocab, are one float32 matrix product (the JAX
``_materialize_t``), or, for an int8 head (``quantize_model_int8`` with
``include_embed_head``), the K10 kernel (the JAX ``_materialize_t_int8``).
Every LoCa, KL and faithful-LoCa term reads that one matrix.

Batch layout as in the JAX package: every leaf has a leading accumulation
axis A, e.g. student_input_ids [A, B, S], labels [A, B, S].  The step reads
``tile_valid`` [A, B, P] to the host once, before its first micro-batch
(``models/llava_onevision.py::tile_layouts``), and hands each micro-batch
the flat indices of its valid tiles (``tile_index``), on which both towers
run SigLIP; a batch that carries ``tile_index`` [A, Nv] itself (every
micro-batch with Nv valid tiles: the memory planner's) is read nothing.

Under an active mesh (``parallel/mesh.py::use_mesh``; the JAX step under
``jax.set_mesh``) each rank runs its rows of the batch
(``parallel/sharding.py::shard_batch``) through a student sharded by
``parallel/sharding.py::shard_params`` (FSDP2 over data/fsdp, whose sharded
float32 parameters are their own masters, and tensor parallelism):

* the fused terms go through the row-sharded ``ops/fused_spmd.py``
  wrappers, as JAX ``step.py:200-230`` does; the chunked route, faithful
  LoCa and NT-Xent take the same global-value, local-gradient form
  (``global_mean``, ``gather_rows``), so every metric is the global one on
  every rank;
* each micro-batch's loss, times data x fsdp, is back-propagated into
  FSDP2's gradients (FSDP2 averages its reduce, the loss's gradient is a
  partial sum over ranks, so the product is the sum); the gradients are
  reduced once a step, on the last micro-batch
  (``set_requires_gradient_sync``), accumulated in float32 before that,
  and divided by A.

Without a mesh the step is unchanged.

While a ``torch.profiler`` records, the step marks its phases as ranges
(``utils/trace.py::span``; each drains the card at its boundaries), and
every kernel the step launches lies in one of the inner ones:

* ``kdss.step``: the whole step, around the others;
* ``kdss.tile_layout``: the one read of the batch's ``tile_valid`` and the
  copy of the valid tiles' indices to the card, before the first
  micro-batch;
* ``kdss.student.forward``: the student's forward (SigLIP, projector, pack,
  Qwen2), once a micro-batch;
* ``kdss.vision`` (``models/llava_onevision.py::encode_images``): SigLIP and
  the projector over one tower's tiles, inside the tower's forward;
* ``kdss.teacher.forward``: the teacher's forward and its logits at 1/T;
* ``kdss.loss``: the labels, the vocabulary terms, NT-Xent, their
  combination and the metrics;
* ``kdss.backward``: the student's backward (the loss kernels' included) and
  the zero fill of unused gradients;
* ``kdss.accumulate``: the gradient carry and the metric sums, once a
  micro-batch, and their mean over A after the last one (off the mesh, only
  where A > 1);
* ``kdss.optimizer`` (``optimizer.py::Optimizer.apply``): AdamW and the
  master -> bf16 copies.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import torch

from ..configs import TrainConfig
from ..losses.chunked import chunked_faithful_loca, chunked_kd_terms
from ..losses.kd_losses import IGNORE_INDEX, masked_ntxent_loss
from ..models.llava_onevision import LlavaOnevision, tile_layouts
from ..models.qwen2 import QLinear
from ..ops._build import is_dtensor
from ..ops.fused_loca import materialize_teacher_logits_int8
from ..ops.fused_spmd import (
    fused_ce_loss_spmd,
    fused_kl_loss_spmd,
    fused_loca_ce_loss_spmd,
    gather_rows,
    global_mean,
)
from ..parallel.mesh import active_mesh, dp_size
from ..utils.trace import span
from .optimizer import Optimizer

_LOCA_MODES = ("logit_based", ("double_trouble", 2), ("double_trouble", 3))
_KL_MODES = (("double_trouble", 1), "feature_based")


class KDModels(NamedTuple):
    student: LlavaOnevision
    teacher: Optional[LlavaOnevision] = None


@dataclasses.dataclass
class TrainState:
    """The student (its parameters), the optimizer and the update count (the
    JAX ``TrainState``'s params, opt_state and step).  ``compute_dtype``: the
    dtype a sharded student computes in (its sharded parameters are float32
    masters); None for an unsharded one, which computes in its own."""

    model: LlavaOnevision
    optimizer: Optimizer
    step: int = 0
    compute_dtype: Optional[torch.dtype] = None


def _fused_head(model: LlavaOnevision) -> torch.Tensor:
    """The head in its stored [V, D] layout ("vd"): the tied embedding, or
    the untied ``lm_head`` (a torch Linear stores [out, in] = [V, D]).
    Read after the model's forward: under FSDP2 the root's parameters are
    then the unsharded ones (the root does not reshard after its forward),
    whose gradients FSDP2 reduces."""
    lm = model.language_model
    w = lm.embed_tokens.weight if model.cfg.text.tie_word_embeddings else lm.lm_head.weight
    if is_dtensor(w):
        raise ValueError("the head is still sharded: read it after the model's forward")
    return w


def teacher_head(model: LlavaOnevision):
    """The teacher's head as :func:`_fused_head` gives it, or, for an int8
    head, the (``weight_q`` int8 [Vt, Dt], ``weight_scale`` f32 [Vt]) pair,
    vocab-major, which K10 reads in place (the JAX ``teacher_head``)."""
    head = getattr(model.language_model, "lm_head", None)
    if isinstance(head, QLinear):
        return head.int8_weight(), head.weight_scale
    return _fused_head(model)


def dense_teacher_head(wt, dtype=torch.bfloat16) -> torch.Tensor:
    """A :func:`teacher_head` as a dense [Vt, Dt] matrix in ``dtype``: an int8
    pair dequantized per row (one [Vt, Dt] temporary, which K10 avoids), a
    float head as it is (the JAX ``dense_teacher_head``, in the port's
    [V, D] head layout)."""
    if isinstance(wt, tuple):
        wq, ws = wt
        return (wq.float() * ws[:, None]).to(dtype)
    return wt


def _forward_hidden(model: LlavaOnevision, batch: Dict[str, torch.Tensor], prefix: str):
    """Run one stream, returning (hidden [B, S, D], vision_feats [B, P, Dv])."""
    _, vis, _, hidden = model(
        input_ids=batch[f"{prefix}_input_ids"],
        attention_mask=batch[f"{prefix}_attention_mask"],
        pixel_values=batch.get(f"{prefix}_pixel_values"),
        pack_idx=batch.get("pack_idx"),
        pack_weight=batch.get("pack_weight"),
        pack_valid=batch.get("pack_valid"),
        tile_valid=batch.get("tile_valid"),
        tile_index=batch.get("tile_index"),
        return_hidden=True,
        compute_logits=False,
    )
    return hidden, vis


def ce_labels(labels: torch.Tensor) -> torch.Tensor:
    """Shift by one for the causal LM and flatten: [B, S] -> [B * S], the
    last position of each row ignored (`step.py:219-222`)."""
    pad = torch.full_like(labels[:, :1], IGNORE_INDEX)
    return torch.cat([labels[:, 1:], pad], dim=1).reshape(-1)


@torch.no_grad()
def _teacher_logits(teacher: LlavaOnevision, batch: Dict[str, torch.Tensor], vocab: int,
                   temperature: float):
    """The frozen teacher's logits at 1/T on the RGB stream, truncated to the
    student vocab: float32 [B * S, vocab] (the JAX ``_materialize_t``); and
    its per-tile vision features [B, P, Dv] from the same forward.

    A float head: one matrix product of the final-norm hidden states with a
    row slice of the untied ``lm_head`` [Vt, Dt] (no copy of the head); bf16
    operands accumulate into a float32 result, as the JAX dot's
    ``preferred_element_type``, outside any kernel, as in the JAX package.
    An int8 head: K10 over the first ``vocab`` rows of the int8 head."""
    from torch.distributed.fsdp import FSDPModule

    t_hidden, t_vis = _forward_hidden(teacher, batch, "teacher")
    th = t_hidden.reshape(-1, t_hidden.shape[-1])
    wt = teacher_head(teacher)
    if isinstance(wt, tuple):
        t = materialize_teacher_logits_int8(th, *wt, 1.0 / temperature, vocab)
    else:
        wt = wt[:vocab]
        if th.dtype == torch.float32:
            t = th @ wt.T
        else:
            t = torch.mm(th, wt.T, out_dtype=torch.float32)
        t.mul_(1.0 / temperature)
    if isinstance(teacher, FSDPModule):
        # FSDP2 keeps a root's own parameters (the embedding, the head)
        # gathered after its forward, for a backward that a frozen teacher
        # never runs: free them once the head has been read.  A bf16
        # teacher too: the rule table holds its root sharded at rest, as the
        # JAX step gathers it inside each step, at the cost of gathering
        # the root again every micro-batch (2 x 152128 x 3584 bf16 bytes at
        # 7B, ~2.03 GiB, of which a rank receives (fsdp - 1) / fsdp)
        teacher.reshard()
    return t, t_vis


CE_IMPLS = ("fused", "chunked")


def make_loss_fn(models: KDModels, cfg: TrainConfig):
    """``loss_fn(micro_batch) -> (loss, metrics)`` on ``models.student``'s
    current parameters (the teacher, if any, is frozen).

    Every term reads the final-norm hidden states flattened to [B * S, D]
    and the head in its [V, D] layout.  baseline: CE over the shifted
    labels.  logit_based / double_trouble phases 2 and 3: LoCa (unshifted
    labels, T and alpha from ``cfg.loss``) and CE against the teacher's
    logits, one combined pipeline under ``ce_impl="fused"`` unless LoCa is
    the faithful one.  double_trouble phase 1 / feature_based: the
    temperature KL against the teacher's logits, NT-Xent over the flattened
    tile features [B * P, Dv] of both towers (padded tiles masked), and for
    feature_based the CE.  Metrics are f32 scalars.
    """
    mode, phase = cfg.kd_mode, cfg.phase
    key = (mode, phase) if mode == "double_trouble" else mode
    if mode != "baseline" and key not in _LOCA_MODES + _KL_MODES:
        raise ValueError(f"unknown kd_mode {mode!r}" + (f" phase {phase}" if mode == "double_trouble" else ""))
    if cfg.ce_impl not in CE_IMPLS:
        raise ValueError(f"ce_impl must be one of {CE_IMPLS}, got {cfg.ce_impl!r}")
    lc = cfg.loss
    if mode != "baseline" and models.teacher is None:
        raise ValueError(f"kd_mode {mode!r} requires a teacher model")
    student, teacher = models.student, models.teacher
    need_loca, need_kl = key in _LOCA_MODES, key in _KL_MODES
    need_ce = mode in ("baseline", "feature_based") or need_loca
    faithful = need_loca and lc.loca_faithful_indexing
    fused = cfg.ce_impl == "fused"

    def loss_fn(batch: Dict[str, torch.Tensor]):
        mesh = active_mesh()
        with span("student.forward"):
            s_hidden, s_vis = _forward_hidden(student, batch, "student")
            flat = s_hidden.reshape(-1, s_hidden.shape[-1])
            head = _fused_head(student)
        tmat = t_vis = None
        if mode != "baseline":
            with span("teacher.forward"):
                tmat, t_vis = _teacher_logits(teacher, batch, head.shape[0], lc.temperature)
        with span("loss"):
            labels = batch["labels"]
            loca_labels, shifted = labels.reshape(-1), ce_labels(labels)
            terms = {}
            if fused and need_loca and not faithful:
                terms["loca"], terms["ce"] = fused_loca_ce_loss_spmd(
                    flat, head, tmat, loca_labels, shifted, temperature=lc.temperature, alpha=lc.loca_alpha)
            elif fused:
                if need_kl:
                    terms["kl"] = fused_kl_loss_spmd(flat, head, tmat, temperature=lc.temperature)
                if need_ce:
                    terms["ce"] = fused_ce_loss_spmd(flat, head, shifted, w_layout="vd")
            else:
                terms = chunked_kd_terms(flat, head, loca_labels, shifted, tmat, temperature=lc.temperature,
                                         alpha=lc.loca_alpha, chunk_size=cfg.loss_chunk_size, need_ce=need_ce,
                                         need_kl=need_kl, need_loca=need_loca and not faithful)
                if mesh is not None:  # per-rank means -> global means
                    counts = {"ce": (shifted != IGNORE_INDEX).sum()}
                    terms = {k: global_mean(v, counts.get(k, flat.shape[0]), mesh) for k, v in terms.items()}
            if faithful:
                terms["loca"] = chunked_faithful_loca(flat, head, loca_labels, tmat, temperature=lc.temperature,
                                                      alpha=lc.loca_alpha, chunk_size=cfg.loss_chunk_size)
                if mesh is not None:
                    terms["loca"] = global_mean(terms["loca"], flat.shape[0], mesh)
            if need_kl:
                s_feat, t_feat = s_vis.flatten(0, 1), t_vis.flatten(0, 1)
                valid = batch["tile_valid"].reshape(-1)
                if mesh is not None:  # negatives from every rank's samples
                    s_feat, t_feat, valid = (gather_rows(x, mesh) for x in (s_feat, t_feat, valid))
                terms["contrastive"] = masked_ntxent_loss(s_feat, t_feat, valid, lc.ntxent_temperature)
            del tmat  # the autograd graph holds it until the backward
            if mode == "baseline":
                loss = terms["ce"]
            elif need_loca and phase == 3 and mode == "double_trouble":
                loss = lc.gamma * (terms["loca"] + terms["ce"]) + (1.0 - lc.gamma) * terms["ce"]
            elif need_loca:
                loss = terms["loca"] + terms["ce"]
            elif mode == "feature_based":
                loss = (lc.soft_target_weight * terms["kl"] + lc.ce_weight * terms["ce"]
                        + lc.contrastive_weight * terms["contrastive"])
            else:
                loss = lc.soft_target_weight * terms["kl"] + lc.contrastive_weight * terms["contrastive"]
            metrics = {k: v.detach().float() for k, v in terms.items()}
            metrics["loss"] = loss.detach().float()
        return loss, metrics

    return loss_fn


def _layouts(batch: Dict[str, Any]):
    """Each micro-batch's valid tiles, from one read of ``tile_valid``; None
    where the batch carries ``tile_index`` itself or has no layout."""
    return None if "tile_index" in batch else tile_layouts(batch.get("tile_valid"))


def _micro(batch: Dict[str, Any], a: int, layouts) -> Dict[str, Any]:
    """Micro-batch ``a``, with its valid tiles' flat indices from
    ``layouts`` (:func:`_layouts` of the whole batch)."""
    micro = {k: v[a] for k, v in batch.items()}
    if layouts is not None:
        micro["tile_index"] = layouts[a]
    return micro


def make_train_step(models: KDModels, cfg: TrainConfig):
    """Build ``step(state, teacher_params, batch) -> (state, metrics)``.

    ``batch`` carries a leading accumulation axis A; gradients are averaged
    over it before one optimizer update.  ``teacher_params`` is accepted
    for the JAX signature; the teacher's weights live in ``models.teacher``.
    """
    loss_fn = make_loss_fn(models, cfg)
    acc_dt = getattr(cfg, "accum_dtype", "float32")
    if acc_dt not in ("float32", "bfloat16", "param"):
        raise ValueError(f"accum_dtype must be float32, bfloat16 or param, got {acc_dt!r}")
    exact = acc_dt == "float32"

    def sharded_step(state: TrainState, batch: Dict[str, torch.Tensor], mesh):
        from torch.distributed.fsdp import FSDPModule

        model = state.model
        if not isinstance(model, FSDPModule):
            raise ValueError("under a mesh the student must be sharded by parallel.shard_params")
        scale = float(dp_size(mesh))
        accum = next(iter(batch.values())).shape[0]
        with span("tile_layout"):
            layouts = _layouts(batch)
        m_acc = None
        for a in range(accum):
            model.set_requires_gradient_sync(a == accum - 1)
            loss, metrics = loss_fn(_micro(batch, a, layouts))
            with span("backward"):
                (loss * scale).backward()
            with span("accumulate"):
                m_acc = metrics if m_acc is None else {k: m_acc[k] + v for k, v in metrics.items()}
        with span("accumulate"):
            grads = {}
            for n, p in state.optimizer.params.items():
                grads[n] = torch.zeros_like(p) if p.grad is None else p.grad / accum
                p.grad = None
            m_acc = {k: v / accum for k, v in m_acc.items()}
        state.optimizer.apply(grads)
        state.step += 1
        return state, m_acc

    def local_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state.optimizer.params  # the trainable ones, by name
        names, leaves = list(params), list(params.values())
        accum = next(iter(batch.values())).shape[0]
        with span("tile_layout"):
            layouts = _layouts(batch)

        def carry_dtype(p):
            return torch.float32 if exact else p.dtype if acc_dt == "param" else torch.bfloat16

        g_acc = m_acc = None
        for a in range(accum):
            loss, metrics = loss_fn(_micro(batch, a, layouts))
            with span("backward"):
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
            if accum == 1:
                g_acc, m_acc = grads, metrics
                break
            with span("accumulate"):
                if g_acc is None:
                    g_acc = [torch.zeros(p.shape, dtype=carry_dtype(p), device=p.device) for p in leaves]
                    m_acc = {k: torch.zeros_like(v) for k, v in metrics.items()}
                for acc, g in zip(g_acc, grads):
                    if exact:
                        acc += g.float()
                    else:
                        # running mean: pre-scale by 1/A so every add combines
                        # same-magnitude terms (`step.py:343-349`)
                        acc += (g.float() / accum).to(acc.dtype)
                del grads
                for k, v in metrics.items():
                    m_acc[k] += v
        if accum > 1:
            with span("accumulate"):
                if exact:
                    for acc in g_acc:
                        acc /= accum
                m_acc = {k: v / accum for k, v in m_acc.items()}
        state.optimizer.apply(dict(zip(names, g_acc)))
        state.step += 1
        return state, m_acc

    def train_step(state: TrainState, teacher_params, batch: Dict[str, torch.Tensor]):
        del teacher_params
        with span("step"):
            mesh = active_mesh()
            if mesh is not None:
                return sharded_step(state, batch, mesh)
            return local_step(state, batch)

    return train_step


def make_eval_step(models: KDModels, cfg: TrainConfig):
    """``eval_step(state, teacher_params, micro_batch) -> metrics`` (the
    reference's ``validation_step`` loss, the KD terms included), without
    gradients."""
    loss_fn = make_loss_fn(models, cfg)

    @torch.no_grad()
    def eval_step(state, teacher_params, batch):
        del state, teacher_params  # the loss reads models.student's parameters
        batch = {k: v[None] for k, v in batch.items()}  # A = 1: one read of the layout, both towers
        return loss_fn(_micro(batch, 0, _layouts(batch)))[1]

    return eval_step
