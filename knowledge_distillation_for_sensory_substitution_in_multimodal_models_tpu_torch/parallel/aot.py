"""Memory plan of the sharded KD step at real model scale, with no weights
materialized (port of the JAX package's ``parallel/aot.py``).

The JAX module compiles the phase-3 KD step ahead of time on abstract
parameters and reads ``compiled.memory_analysis()`` as the per-chip budget.
PyTorch runs eagerly, so its counterpart runs one step, forward, backward
and AdamW, under ``FakeTensorMode``: every tensor carries its shape, dtype,
device and strides and no storage, and
``torch.distributed._tools.mem_tracker.MemTracker`` (``FSDPMemTracker``
where FSDP2 shards the models) counts the bytes each allocation would take
on the card, by category, and the peak.  Under a mesh the step runs as rank
0 of a process group of ``data * fsdp * tensor`` ranks that the caller
starts, as the JAX caller supplies its virtual devices: a group of the
``fake`` backend (``torch.testing._internal.distributed.fake_pg.FakeStore``),
whose collectives return at once, so one process on one card (or none)
plans an 8-card mesh.

The models are built on the ``meta`` device, quantized there where asked
(``ops/int8.py::quantize_model_int8``), then given fake storage on the card
(``to_empty`` under the fake mode) and sharded by
``parallel/sharding.py::shard_params``; the optimizer is the port's own
(``train/optimizer.py``) and the step is ``train/step.py``'s, fed a batch of
``utils/synthetic.py``'s shapes.  The kernel launchers return at once on a
fake tensor (``ops/_build.py``), after their op modules have allocated every
output and scratch buffer, so the traced step takes the kernel routes of
the card (the flash kernels, K11, K10, K12, ...) and allocates what the
real step allocates; the JAX CPU compile instead takes
``attn_impl="xla_chunked"`` because Pallas does not lower there.  The
wrappers' launch counters count the traced launches.

``stats`` uses the JAX keys where they mean the same thing:
``argument_bytes`` (what is resident when the step starts: parameters,
float32 masters, AdamW moments, the batch), ``temp_bytes`` (the step's own
peak above that), ``peak_bytes`` and ``per_chip_hbm_estimate``, with the
tracker's categories beside them.  ``output_bytes``, ``alias_bytes`` and
``generated_code_bytes`` have no counterpart: an eager step updates its
state in place and compiles no program.

Where autograd runs: a CPU-only build of torch cannot record a CUDA tensor
(autograd's input metadata takes the CUDA device guard, which such a build
lacks), so there the planner traces with ``device="cpu"``, the routes the
port takes on a CPU (the plain attention and the chunked losses); the
kernel routes are traced on the card's machine.  :func:`sharded_param_bytes`
and :func:`placed_param_bytes` are arithmetic on a model built on ``meta``
and run anywhere.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import torch
from torch.distributed._tools.fsdp2_mem_tracker import FSDPMemTracker
from torch.distributed._tools.mem_tracker import MemTracker, _MemRefType
from torch._subclasses.fake_tensor import FakeTensorMode

from ..configs import (
    LlavaOnevisionConfig,
    TrainConfig,
    kd_loss_config_for,
    llava_onevision_0_5b,
    llava_onevision_7b,
)
from .mesh import AXIS_DATA, AXIS_FSDP, AXIS_TENSOR, MeshConfig, make_mesh
from .sharding import param_partition_specs, shard_batch, shard_params, tensor_plan

def depth_reduced(cfg: LlavaOnevisionConfig, layers: int = 2) -> LlavaOnevisionConfig:
    """Width-exact, depth-reduced variant: real hidden/vocab/head/mlp dims,
    ``layers`` decoder + vision layers."""
    return dataclasses.replace(
        cfg,
        text=dataclasses.replace(cfg.text, num_hidden_layers=layers),
        vision=dataclasses.replace(cfg.vision, num_hidden_layers=layers),
    )


def teacher_7b_student_05b(
    layers: Optional[int] = None, max_tiles: int = 5
) -> Tuple[LlavaOnevisionConfig, LlavaOnevisionConfig]:
    """The product model pair (`OnlineKnowledgeDistillationLLavaOneVision.py:
    29-59`): (0.5B student, 7B teacher), optionally depth-reduced."""
    scfg = dataclasses.replace(llava_onevision_0_5b(), max_tiles=max_tiles)
    tcfg = dataclasses.replace(llava_onevision_7b(), max_tiles=max_tiles)
    if layers is not None:
        scfg, tcfg = depth_reduced(scfg, layers), depth_reduced(tcfg, layers)
    return scfg, tcfg


def _axis_sizes(mesh) -> Dict[str, int]:
    if isinstance(mesh, MeshConfig):
        return {AXIS_DATA: mesh.data, AXIS_FSDP: mesh.fsdp, AXIS_TENSOR: mesh.tensor}
    if isinstance(mesh, dict):
        return {a: mesh.get(a, 1) for a in (AXIS_DATA, AXIS_FSDP, AXIS_TENSOR)}
    return {a: mesh.size(i) for i, a in enumerate(mesh.mesh_dim_names)}


def sharded_param_bytes(model: torch.nn.Module, mesh) -> int:
    """Per-chip parameter bytes under the partition rules (the JAX
    arithmetic: each parameter's bytes divided by the product of the mesh
    axes its spec uses), over ``parallel/sharding.py``'s rule table.
    ``mesh``: a DeviceMesh, a MeshConfig or an {axis: size} dict; ``model``
    may live on ``meta``."""
    sizes = _axis_sizes(mesh)
    total = 0
    for name, spec in param_partition_specs(model, sizes).items():
        p = model.get_parameter(name)
        div = math.prod(sizes[a] for a in spec if a is not None)
        total += p.numel() * p.element_size() // div
    return total


def placed_param_bytes(model: torch.nn.Module, mesh) -> int:
    """The parameter bytes that ``shard_params`` places on rank 0 of
    ``mesh``: the tensor plan's Linears and ``QLinear``s (``tensor_plan``)
    hold 1/tensor of their weight, column-wise ones of every leaf
    (``weight_scale`` and bias too), row-wise ones of ``weight`` /
    ``weight_q`` only; FSDP2 then splits every parameter's dim 0, int8,
    float32 and bf16 alike, over ``fsdp`` into padded chunks of
    ceil(dim0 / fsdp) rows (replicated over ``data``).  ``model``:
    unsharded, e.g. on ``meta``."""
    sizes = _axis_sizes(mesh)
    t, f = sizes[AXIS_TENSOR], sizes[AXIS_FSDP]
    plan = tensor_plan(model, t)
    total = 0
    for name, p in model.named_parameters():
        module, _, leaf = name.rpartition(".")
        shape = list(p.shape)
        style = plan.get(module)
        if style == "colwise":
            shape[0] //= t
        elif style == "rowwise" and leaf in ("weight", "weight_q"):
            shape[1] //= t
        shape[0] = -(-shape[0] // f)
        total += math.prod(shape) * p.element_size()
    return total


def meta_models(scfg: LlavaOnevisionConfig, tcfg: LlavaOnevisionConfig, teacher_quant: str = "none",
                teacher_embed_quant: str = "none", *, param_dtype=torch.bfloat16, attn_impl: str = "xla",
                remat: bool = False):
    """(student, teacher) on the ``meta`` device in ``param_dtype``: the
    student in train mode, the teacher frozen in eval mode and quantized by
    ``quantize_model_int8`` where asked (``teacher_quant`` "int8": its
    decoder projections, "int8_full": its SigLIP ones too;
    ``teacher_embed_quant`` "int8": its embedding and head)."""
    from ..models.llava_onevision import LlavaOnevision
    from ..ops.int8 import quantize_model_int8

    if teacher_quant not in ("none", "int8", "int8_full") or teacher_embed_quant not in ("none", "int8"):
        raise ValueError(f"teacher_quant {teacher_quant!r}, teacher_embed_quant {teacher_embed_quant!r}")
    student = LlavaOnevision(scfg, attn_impl=attn_impl, device="meta", dtype=param_dtype, remat=remat).train()
    teacher = LlavaOnevision(tcfg, attn_impl=attn_impl, device="meta", dtype=param_dtype, remat=remat)
    teacher.requires_grad_(False).eval()
    if teacher_quant != "none" or teacher_embed_quant != "none":
        quantize_model_int8(teacher, include_vision=teacher_quant == "int8_full",
                            include_embed_head=teacher_embed_quant == "int8")
    return student, teacher


def build_kd_step_for_aot(
    scfg: LlavaOnevisionConfig,
    tcfg: LlavaOnevisionConfig,
    mesh_cfg: MeshConfig,
    *,
    seq_len: int = 3072,
    per_dp_batch: int = 1,
    accum: int = 2,
    orig: Tuple[int, int] = (530, 730),
    teacher_quant: str = "none",
    teacher_embed_quant: str = "none",
    param_dtype=torch.bfloat16,
    attn_impl: Optional[str] = None,
    phase: int = 3,
    loss_chunk_size: int = 128,
    remat: bool = True,
    device: str = "cuda",
    mesh=None,
):
    """Build the phase-``phase`` KD step and its state on fake tensors.

    Returns ``(step, (state, None, batch), mesh)`` as the JAX function
    returns the jitted step and its abstract arguments (the teacher lives in
    the step's ``KDModels``, ``step.models``, so its parameter slot is
    None); the batch holds this rank's rows.  Nothing is materialized: run
    the step under the fake mode its tensors carry
    (:func:`aot_compile_kd_step` does).

    ``mesh_cfg`` of one device plans the single-card step (no process
    group, no sharding, the float32 masters apart from the bf16 model);
    more than one needs the default process group of that many ranks (the
    caller's, e.g. the ``fake`` backend), and the student is then float32
    (its sharded parameters are its masters) computing in ``param_dtype``
    and both models go through ``shard_params``, as the KD CLI under
    ``--mesh`` builds them.  ``remat`` recomputes each layer of both models
    in the backward (the "full" policy), as JAX ``:133-148`` and the KD CLI
    at full width build them.  ``attn_impl`` defaults to the kernels on
    ``device="cuda"`` ("pallas_spmd" under a mesh) and the plain attention
    on the CPU; the vocabulary losses take the fused kernels on the card and
    the chunked route on the CPU.
    """
    from ..train import KDModels, TrainState, make_optimizer, make_train_step
    from ..utils.synthetic import synthetic_kd_batch

    on_card = torch.device(device).type == "cuda"
    sharded = mesh_cfg.num_devices > 1
    if sharded and mesh is None:
        mesh = make_mesh(mesh_cfg, "cuda" if on_card else "cpu")
    if attn_impl is None:
        attn_impl = ("pallas_spmd" if sharded else "flash") if on_card else "xla"

    student, teacher = meta_models(scfg, tcfg, teacher_quant, teacher_embed_quant, param_dtype=param_dtype,
                                   attn_impl=attn_impl, remat=remat)
    if sharded:
        student.float()

    global_batch = per_dp_batch * mesh_cfg.data * mesh_cfg.fsdp
    host = synthetic_kd_batch(scfg, batch_size=global_batch, seq_len=seq_len,
                              orig_sizes=[orig] * global_batch, accum=accum, seed=0)
    if sharded:
        host = shard_batch(host, mesh)
    cfg = TrainConfig(
        kd_mode="double_trouble", phase=phase, loss=kd_loss_config_for("double_trouble"),
        loss_chunk_size=loss_chunk_size, ce_impl="fused" if on_card else "chunked",
        accumulate_grad_batches=accum, mesh_shape=mesh_cfg.shape,
    )

    if sharded:  # on meta: DeviceMesh's own bookkeeping cannot run on fake tensors
        shard_params(student, mesh, param_dtype=param_dtype)
        shard_params(teacher, mesh)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        student.to_empty(device=device)
        teacher.to_empty(device=device)
        # the batch's shapes and dtypes; its values are never read
        batch = {k: torch.empty(v.shape, dtype=torch.from_numpy(v[:0]).dtype, device=device)
                 for k, v in host.items()}
        # the valid tiles' flat indices, which the step reads from tile_valid's
        # values on the card: each micro-batch has the same frames here
        batch["tile_index"] = torch.empty((accum, int(host["tile_valid"][0].sum())), dtype=torch.int64,
                                          device=device)
        optimizer = make_optimizer(student, cfg.learning_rate, cosine_t_max=cfg.cosine_t_max,
                                   steps_per_epoch=100, kd_mode=cfg.kd_mode, phase=cfg.phase)
        if on_card and not sharded:
            # AdamW takes its foreach route (one temporary the size of all the
            # masters) for plain CUDA tensors, but not for FakeTensor, a
            # subclass; DTensor masters take it either way
            for group in optimizer.opt.param_groups:
                group["foreach"] = True
        # AdamW makes its moments at its first update: make them now, so the
        # traced step starts from the steady state (the JAX TrainState holds
        # its moments from the start)
        optimizer.apply({n: torch.zeros_like(m) for n, m in optimizer.masters.items()})
        optimizer.count = 0
        state = TrainState(student, optimizer, compute_dtype=param_dtype if sharded else None)
    step = make_train_step(KDModels(student, teacher), cfg)
    step.models = KDModels(student, teacher)
    return step, (state, None, batch), mesh


class _RootAgain:
    """The trackers refuse a second call of a root module in one tracked
    region (they were written for one forward a step); the KD step runs the
    student and the teacher once a micro-batch.  A root called again starts
    a fresh record; the peak and the categories, all that is read here, are
    kept across.  The per-module peaks, never read here, are not updated
    (``MemTracker`` walks every module on every op for them);
    ``category_max`` keeps each category's most bytes at any one time.
    Ops run while ``_paused`` (DTensor's sharding propagation, see
    :func:`_propagation_untracked`) are not counted."""

    category_max: Dict[str, int]

    def _root_again(self, module) -> None:
        fqn = self._mod_tracker.get_known_fqn(module)
        if (module in self.memory_tracking and not self._mod_tracker.is_bw
                and set(self._mod_tracker.parents) - {fqn} == {"Global"}):
            del self.memory_tracking[module]

    _paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self._paused:
            return func(*args, **(kwargs or {}))
        return super().__torch_dispatch__(func, types, args, kwargs)

    def _update_peak_stats(self, peak_state) -> None:
        for dev, snap in self._curr_mem_snap.items():
            if self._peak_mem.get(dev, 0) < snap["Total"]:
                self._peak_mem[dev] = snap["Total"]
                self._peak_mem_snap[dev] = dict(snap)
            if torch.device(dev).type != self.device_type:
                continue
            most = self.category_max
            for k, v in snap.items():
                key = str(getattr(k, "value", k))
                if v > most.get(key, 0):
                    most[key] = v


class StepTracker(_RootAgain, MemTracker):
    """``MemTracker`` for the unsharded step: gradient hooks only on the
    parameters that train (a frozen teacher's take none)."""

    def _track_module_params_and_buffers(self, module, install_grad_hooks=True):
        mem = super()._track_module_params_and_buffers(module, install_grad_hooks=False)
        if install_grad_hooks:
            def grad(g):
                self._update_and_maybe_create_winfos(g, _MemRefType.GRAD)

            for p in module.parameters():
                if p.requires_grad and self._param_to_grad_hook_handles.get(p) is None:
                    self._param_to_grad_hook_handles[p] = (
                        p.register_hook(grad), p.register_post_accumulate_grad_hook(lambda q: grad(q.grad)))
        return mem

    def _pre_fw_hook(self, module, inputs):
        self._root_again(module)
        super()._pre_fw_hook(module, inputs)


class MeshTracker(_RootAgain, FSDPMemTracker):
    """``FSDPMemTracker`` over several roots (the student and the teacher,
    bf16 or int8, both sharded by FSDP2); ``inputs`` the batch."""

    def __init__(self, roots, optimizer, inputs=()):
        super().__init__(roots[0], optimizer)
        self._roots, self._inputs = roots, inputs

    def _instrument_fsdp_module(self) -> None:
        for root in self._roots:
            self._root_mod = root
            super()._instrument_fsdp_module()
        self.track_inputs(self._inputs)

    def _fsdp_state_pre_forward(self, fsdp_mod, orig):
        inner = super()._fsdp_state_pre_forward(fsdp_mod, orig)

        @functools.wraps(inner)
        def again(*args, **kwargs):
            self._root_again(fsdp_mod)
            return inner(*args, **kwargs)

        return again


@contextlib.contextmanager
def _propagation_untracked(tracker):
    """Keep DTensor's sharding propagation out of ``tracker``'s count.  To
    find an op's output shape, DTensor runs the op on fake tensors of the
    global (unsharded) shapes in the active fake mode, which here is the
    planner's own, so the tracker cannot tell them from the rank's local
    tensors by their mode: a foreach AdamW update over the student's
    DTensor masters would count every master, moment and temporary at its
    unsharded size.  No real step allocates them."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = "_propagate_tensor_meta_non_cached"
    orig = getattr(ShardingPropagator, name)

    @functools.wraps(orig)
    def untracked(self, *args, **kwargs):
        tracker._paused += 1
        try:
            return orig(self, *args, **kwargs)
        finally:
            tracker._paused -= 1

    setattr(ShardingPropagator, name, untracked)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


def _category_bytes(snap: dict, device) -> Dict[str, int]:
    """The snapshot's categories on ``device`` (AdamW's step counters,
    host tensors, are left out on the card)."""
    dev_snap = next((v for d, v in snap.items() if torch.device(d).type == torch.device(device).type), {})
    return {str(getattr(k, "value", k)): v for k, v in dev_snap.items()}


def aot_compile_kd_step(*args, **kwargs):
    """Run one KD step (forward, backward, AdamW) of
    :func:`build_kd_step_for_aot`'s state on fake tensors under a memory
    tracker and return ``(step, stats)``.

    ``stats`` (bytes on one card, rank 0 under a mesh): ``argument_bytes``,
    what is resident when the step starts (parameters, float32 masters,
    AdamW moments, the batch); ``peak_bytes``, the most resident at once
    during the step; ``temp_bytes`` = peak - arguments;
    ``per_chip_hbm_estimate`` = the peak (the arguments stay resident for
    the whole step, so the peak holds them); ``categories``, the tracker's
    categories at the start (``at_start``), at the peak (``at_peak``) and
    each at its own most (``max``);
    ``traced_launches``, the kernel launches the step reached.  No
    ``output_bytes``, ``alias_bytes`` or ``generated_code_bytes``: the step
    updates its state in place and compiles no program."""
    from ..ops import flash_attention, fused_ce, fused_kl, fused_loca, int8
    from .mesh import use_mesh

    step, (state, tparams, batch), mesh = build_kd_step_for_aot(*args, **kwargs)
    student, teacher = step.models.student, step.models.teacher
    mode = next(iter(batch.values())).fake_mode
    for ops in (flash_attention, fused_ce, fused_kl, fused_loca, int8):
        ops.reset_launch_counts()
    with mode:
        if mesh is None:
            tracker = StepTracker()
            tracker.track_external(student, teacher, state.optimizer.opt, *batch.values())
            # the float32 masters of the bf16 parameters: AdamW's own tensors
            tracker.track_external(*(m for n, m in state.optimizer.masters.items()
                                     if m is not state.optimizer.params[n]))
        else:
            tracker = MeshTracker([student, teacher], state.optimizer.opt, inputs=tuple(batch.values()))
        tracker.category_max, tracker.device_type = {}, student.device.type
        with tracker, use_mesh(mesh), _propagation_untracked(tracker):
            start = tracker.get_tracker_snapshot("current")
            step(state, tparams, batch)
        peak = tracker.get_tracker_snapshot("peak")
    device = student.device
    at_start, at_peak = _category_bytes(start, device), _category_bytes(peak, device)
    stats = {
        "argument_bytes": at_start.get("Total", 0),
        "peak_bytes": at_peak.get("Total", 0),
    }
    stats["temp_bytes"] = stats["peak_bytes"] - stats["argument_bytes"]
    stats["per_chip_hbm_estimate"] = stats["peak_bytes"]
    stats["categories"] = {"at_start": at_start, "at_peak": at_peak, "max": tracker.category_max}
    stats["traced_launches"] = {
        "flash_fwd": flash_attention.flash_attention.launches + flash_attention.flash_attention_gqa.launches,
        "flash_bwd": flash_attention.flash_attention_bwd.launches + flash_attention.flash_attention_gqa_bwd.launches,
        "fused_loca_ce": fused_loca.loca_ce_fwd.launches + fused_loca.loca_ce_bwd.launches,
        "tmat_int8": fused_loca.materialize_teacher_logits_int8.launches,
        "int8_mm": int8.int8_matmul.launches,
    }
    return step, stats
