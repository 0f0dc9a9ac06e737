"""Mesh-aware wrappers of the fused vocabulary losses (port of the JAX
package's ``ops/fused_spmd.py``).

Under an active mesh (``parallel/mesh.py::use_mesh``) every rank holds its
own rows of the batch, split over (data, fsdp) by
``parallel/sharding.py::shard_batch`` and whole over ``tensor``.  Each
wrapper:

* splits its rows once more over ``tensor`` when the tensor size divides
  them (:func:`_row_axes`: the heads enter whole, so the rows may shard over
  ``tensor`` too), and otherwise runs every row on every rank of a tensor
  group, as the JAX kernel runs replicated when no axis divides;
* runs the single-device kernel of its loss on those rows in its sum form
  (K5/K6, K7/K8, K9, K11; their plain versions on the CPU);
* all-reduces the partial sums and counts over the ranks that hold distinct
  rows, and takes the global mean after the all-reduce.

Every rank then holds the global loss.  Its gradient is the exact gradient
of that loss in the rank's own rows: the all-reduce's backward passes the
gradient through unchanged (the other ranks' sums are constants to this
rank), the row split over ``tensor`` gathers the rows' gradients back in
its backward, and a head shared by a tensor group sums its gradient over
the group.  A parameter's gradient is then a partial sum over the rows of
(data, fsdp), which the caller sums once across those ranks (the train
step scales its loss by data x fsdp, since FSDP2 averages its reduce).
The 1/N of the mean is applied exactly once, here.

The teacher enters as its logits ``tmat`` [N, V] (f32, at 1/T), as in the
single-device wrappers, row-sharded like the student's rows; the TPU's
teacher-logits knobs (``_single_tmode``, ``_tmat_row_chunk``,
``_rowchunked``) are not ported.  With no active mesh each wrapper is its
single-device fused loss.

:func:`global_mean` and :func:`gather_rows` give the step's other terms
(the chunked route, faithful LoCa, NT-Xent) the same global-value,
local-gradient form.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

from ..parallel.mesh import (
    AXIS_DATA,
    AXIS_FSDP,
    AXIS_TENSOR,
    active_mesh,
    all_reduce_sum,
    axis_rank,
    axis_size,
    dp_rank,
)
from .fused_ce import fused_ce_loss, fused_ce_sum
from .fused_kl import fused_kl_loss, kl_rows
from .fused_loca import _check_tmat, fused_loca_ce_loss, fused_loca_loss, loca_ce_rows, loca_rows

_DP = (AXIS_DATA, AXIS_FSDP)


def _row_axes(sizes: Dict[str, int], n_rows: int) -> Tuple[str, ...]:
    """Axis combo (subset of data/fsdp/tensor, mesh order) maximizing the
    shard count that divides N (the JAX ``_row_axes`` on axis sizes)."""
    names = ("data", "fsdp", "tensor")
    best, best_prod = (), 1
    for bits in range(1, 8):
        axes = tuple(a for i, a in enumerate(names) if bits >> i & 1)
        prod = 1
        for a in axes:
            prod *= sizes.get(a, 1)
        if prod > best_prod and n_rows % prod == 0:
            best, best_prod = axes, prod
    return best


class _SumAcross(torch.autograd.Function):
    """All-reduce (sum) of scalars over the mesh ``axes``; the backward
    passes each gradient through unchanged."""

    @staticmethod
    def forward(ctx, mesh, axes, *vals):
        flat = torch.stack([v.detach().to(torch.float32).reshape(()) for v in vals])
        all_reduce_sum(flat, mesh, axes)
        return tuple(flat[i].to(v.dtype) if v.is_floating_point() else flat[i] for i, v in enumerate(vals))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + grads


class _TensorRows(torch.autograd.Function):
    """This tensor rank's rows of ``x``; the backward all-gathers the rows'
    gradients over the tensor group, so every rank of the group holds the
    gradient of all of its rows."""

    @staticmethod
    def forward(ctx, mesh, x):
        t, r = axis_size(mesh, AXIS_TENSOR), axis_rank(mesh, AXIS_TENSOR)
        n = x.shape[0] // t
        ctx.mesh = mesh
        return x[r * n:(r + 1) * n].contiguous()

    @staticmethod
    def backward(ctx, g):
        group = ctx.mesh.get_group(AXIS_TENSOR)
        parts = [torch.empty_like(g) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, g.contiguous(), group=group)
        return None, torch.cat(parts)


class _TensorGradSum(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the tensor
    group (a head shared by ranks that each took some of the rows)."""

    @staticmethod
    def forward(ctx, mesh, w):
        ctx.mesh = mesh
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.mesh.get_group(AXIS_TENSOR))
        return None, g


def _plan(mesh, n_rows: int) -> Tuple[bool, Tuple[str, ...]]:
    """(split the rows over tensor, the axes whose ranks hold distinct rows)."""
    split = AXIS_TENSOR in _row_axes({AXIS_TENSOR: axis_size(mesh, AXIS_TENSOR)}, n_rows)
    return split, (_DP + (AXIS_TENSOR,) if split else _DP)


def _local(mesh, split, w, grads, plain):
    """The head and this rank's rows (differentiable ones, then plain ones)."""
    if not split:
        return w, grads, plain
    t, r = axis_size(mesh, AXIS_TENSOR), axis_rank(mesh, AXIS_TENSOR)
    n = plain[0].shape[0] // t if plain else grads[0].shape[0] // t
    w = _TensorGradSum.apply(mesh, w) if w.requires_grad else w
    return (w, tuple(_TensorRows.apply(mesh, x) for x in grads),
            tuple(x[r * n:(r + 1) * n] for x in plain))


def fused_ce_loss_spmd(hidden: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, *,
                       w_layout: str = "dv") -> torch.Tensor:
    """Row-sharded fused CE: the mean NLL over ``labels != -100`` of every
    rank's rows (``ops/fused_ce.py::fused_ce_loss``'s contract)."""
    mesh = active_mesh()
    if mesh is None:
        return fused_ce_loss(hidden, w, labels, w_layout=w_layout)
    split, axes = _plan(mesh, hidden.shape[0])
    w, (h,), (lab,) = _local(mesh, split, w, (hidden,), (labels,))
    nll, count = fused_ce_sum(h, w, lab, w_layout=w_layout)
    nll, count = _SumAcross.apply(mesh, axes, nll, count)
    return nll / count.clamp(min=1)


def fused_kl_loss_spmd(hs: torch.Tensor, ws_vd: torch.Tensor, tmat: torch.Tensor, *,
                       temperature: float) -> torch.Tensor:
    """Row-sharded temperature KL: the sum of every rank's KL rows /
    (N * V) * T^2, N the global row count (``fused_kl_loss``'s contract)."""
    mesh = active_mesh()
    if mesh is None:
        return fused_kl_loss(hs, ws_vd, tmat, temperature=temperature)
    _check_tmat(hs, ws_vd, tmat)
    v = ws_vd.shape[0]
    split, axes = _plan(mesh, hs.shape[0])
    ws_vd, (h,), (tm,) = _local(mesh, split, ws_vd, (hs,), (tmat,))
    total = kl_rows(h, ws_vd, tm, inv_t=1.0 / temperature).sum()
    total, n = _SumAcross.apply(mesh, axes, total, torch.tensor(h.shape[0], device=h.device))
    return total / (n * v) * temperature**2


def fused_loca_loss_spmd(hs, ws_vd, tmat, labels, *, temperature: float, alpha: float = 0.8,
                         eps: float = 1e-8) -> torch.Tensor:
    """Row-sharded LoCa KL (K9): the sum of every rank's calibrated-KL rows /
    (N * V) * T^2 (``fused_loca_loss``'s contract).  LoCa's calibration is
    per row, so the rows split with no exchange of statistics."""
    mesh = active_mesh()
    if mesh is None:
        return fused_loca_loss(hs, ws_vd, tmat, labels, temperature=temperature, alpha=alpha, eps=eps)
    _check_tmat(hs, ws_vd, tmat)
    v = ws_vd.shape[0]
    split, axes = _plan(mesh, hs.shape[0])
    ws_vd, (h,), (tm, lab) = _local(mesh, split, ws_vd, (hs,), (tmat, labels))
    total = loca_rows(h, ws_vd, tm, lab, inv_t=1.0 / temperature, alpha=alpha, eps=eps).sum()
    total, n = _SumAcross.apply(mesh, axes, total, torch.tensor(h.shape[0], device=h.device))
    return total / (n * v) * temperature**2


def fused_loca_ce_loss_spmd(hs, ws_vd, tmat, loca_labels, ce_labels, *, temperature: float,
                            alpha: float, eps: float = 1e-8):
    """Row-sharded combined LoCa + CE (K11): (LoCa loss, CE loss) with the
    global reductions of :func:`fused_loca_loss_spmd` and
    :func:`fused_ce_loss_spmd` (``fused_loca_ce_loss``'s contract)."""
    mesh = active_mesh()
    if mesh is None:
        return fused_loca_ce_loss(hs, ws_vd, tmat, loca_labels, ce_labels, temperature=temperature,
                                  alpha=alpha, eps=eps)
    _check_tmat(hs, ws_vd, tmat)
    v = ws_vd.shape[0]
    split, axes = _plan(mesh, hs.shape[0])
    ws_vd, (h,), (tm, lab, lab_ce) = _local(mesh, split, ws_vd, (hs,), (tmat, loca_labels, ce_labels))
    kl, ce = loca_ce_rows(h, ws_vd, tm, lab, lab_ce, inv_t=1.0 / temperature, alpha=alpha, eps=eps)
    kl_sum, ce_sum, count, n = _SumAcross.apply(
        mesh, axes, kl.sum(), ce.sum(), (lab_ce >= 0).sum(), torch.tensor(h.shape[0], device=h.device))
    return kl_sum / (n * v) * temperature**2, ce_sum / count.clamp(min=1)


def global_mean(value: torch.Tensor, count, mesh) -> torch.Tensor:
    """A per-rank mean over ``count`` of the rank's rows -> the mean over
    every rank's rows of (data, fsdp), with the gradient in this rank's
    rows only (see the module docstring)."""
    count = torch.as_tensor(count, device=value.device)
    total, n = _SumAcross.apply(mesh, _DP, value * count.clamp(min=1), count.clamp(min=1))
    return total / n


class _GatherRows(torch.autograd.Function):
    """Every (data, fsdp) rank's rows of ``x``, in the order of the global
    batch; the backward keeps this rank's own rows' gradient."""

    @staticmethod
    def forward(ctx, mesh, x):
        ctx.rows, ctx.index = x.shape[0], dp_rank(mesh)
        for axis in (AXIS_FSDP, AXIS_DATA):  # innermost first: data outermost in the result
            if axis_size(mesh, axis) > 1:
                group = mesh.get_group(axis)
                parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
                dist.all_gather(parts, x.contiguous(), group=group)
                x = torch.cat(parts)
        return x

    @staticmethod
    def backward(ctx, g):
        return None, g[ctx.index * ctx.rows:(ctx.index + 1) * ctx.rows]


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """The global batch's rows of ``x`` on every rank (NT-Xent's negatives
    come from every sample), differentiable in this rank's rows."""
    return _GatherRows.apply(mesh, x)
