"""Spawned gloo ranks on the CPU for the port's multi-rank tests.

``spawn(fn, world, *args)`` runs ``fn(rank, world, *args)`` in ``world``
fresh processes joined in one gloo process group (``tcp://127.0.0.1`` on a
free port) and returns each rank's result, in rank order.  ``fn`` must be
importable by the children (a function of this module or of a module that
imports no JAX), and its result picklable by ``torch.save``.
"""

from __future__ import annotations

import os
import socket
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, outdir, fn, args):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            init_method=f"tcp://127.0.0.1:{port}")
    try:
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        if dist.is_initialized():  # a CLI's main leaves the group itself
            dist.destroy_process_group()


def spawn(fn, world: int, *args):
    with tempfile.TemporaryDirectory() as outdir:
        mp.spawn(_entry, args=(world, _free_port(), outdir, fn, args), nprocs=world, join=True)
        return [torch.load(os.path.join(outdir, f"rank{r}.pt"), weights_only=False) for r in range(world)]


def kd_step_worker(rank, world, cases, student_sd, teacher_sd, batch, lr):
    """One ``make_train_step`` step of the tiny port models on each case
    ``(mesh shape, kd_mode, phase, ce_impl, teacher quant)`` whose mesh spans ``world``
    ranks: the student and teacher sharded by ``shard_params``, this rank's
    rows of ``batch`` (numpy, [A, B, ...]).  Returns {case: (loss, the full
    updated student state dict, the whole gradients the optimizer took),
    the last two on rank 0 only}."""
    import dataclasses
    import math

    from torch.distributed.checkpoint.state_dict import StateDictOptions, get_model_state_dict

    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch import configs as pc
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.models import LlavaOnevision
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.parallel import (
        MeshConfig, make_mesh, shard_batch, shard_params, use_mesh)
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.train import (
        KDModels, TrainState, make_optimizer, make_train_step)

    out = {}
    for case in cases:
        shape, mode, phase, ce_impl, teacher_quant = case
        if math.prod(shape) != world:
            continue
        mesh = make_mesh(MeshConfig(*shape))
        student = LlavaOnevision(pc.llava_onevision_tiny(), attn_impl="xla")
        student.load_state_dict(student_sd)
        teacher = None
        if mode != "baseline":
            teacher = tiny_teacher(teacher_sd, teacher_quant)
            shard_params(teacher, mesh)
        shard_params(student.train(), mesh)
        state = TrainState(student, make_optimizer(student, lr, kd_mode=mode, phase=phase),
                           compute_dtype=torch.float32)
        loss_cfg = dataclasses.replace(pc.kd_loss_config_for(mode)) if mode != "baseline" else pc.KDLossConfig()
        cfg = pc.TrainConfig(kd_mode=mode, phase=phase, loss=loss_cfg, ce_impl=ce_impl, loss_chunk_size=32)
        grads = record_grads(state.optimizer)
        step = make_train_step(KDModels(student, teacher), cfg)
        local = {k: torch.from_numpy(v) for k, v in shard_batch(batch, mesh).items()}
        with use_mesh(mesh):
            state, m = step(state, None, local)
        full = get_model_state_dict(student, options=StateDictOptions(full_state_dict=True, cpu_offload=True))
        out[case] = (float(m["loss"]), full if rank == 0 else None, grads if rank == 0 else None)
    return out


def tiny_teacher(state_dict, quant: str):
    """The frozen tiny teacher; ``quant="int8"`` quantizes it as the KD
    benchmark does (int8_full, the int8 embedding and vocab-major head)."""
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch import configs as pc
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.models import LlavaOnevision
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops.int8 import (
        quantize_model_int8)

    teacher = LlavaOnevision(pc.llava_onevision_tiny_teacher(), attn_impl="xla")
    teacher.load_state_dict(state_dict)
    if quant == "int8":
        quantize_model_int8(teacher, include_vision=True, include_embed_head=True)
    return teacher.requires_grad_(False).eval()


def record_grads(optimizer) -> dict:
    """Make ``optimizer.apply`` also keep the whole gradient it is given, by
    name (a DTensor gathered in full); returns the dict it fills."""
    from torch.distributed.tensor import DTensor

    seen = {}
    apply = optimizer.apply

    def recording(grads):
        seen.update({n: (g.full_tensor() if isinstance(g, DTensor) else g).detach().clone()
                     for n, g in grads.items()})
        return apply(grads)

    optimizer.apply = recording
    return seen


def spmd_loss(name, h, w, tmat, labels, ce_labels):
    """One of the four ``ops/fused_spmd.py`` wrappers on the given rows, as
    a scalar (the combined LoCa + CE as 0.8 LoCa + CE)."""
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops import fused_spmd as fs

    if name == "ce":
        return fs.fused_ce_loss_spmd(h, w, ce_labels, w_layout="vd")
    if name == "kl":
        return fs.fused_kl_loss_spmd(h, w, tmat, temperature=0.8)
    if name == "loca":
        return fs.fused_loca_loss_spmd(h, w, tmat, labels, temperature=0.8, alpha=0.8)
    loca, ce = fs.fused_loca_ce_loss_spmd(h, w, tmat, labels, ce_labels, temperature=0.8, alpha=0.8)
    return 0.8 * loca + ce


def dp_rows(n: int, dp: int, index: int) -> slice:
    """Rank ``index``'s rows of ``n`` over ``dp`` ranks (uneven when ``dp``
    does not divide ``n``, as ``numpy.array_split``)."""
    parts = np.array_split(np.arange(n), dp)[index]
    return slice(int(parts[0]), int(parts[-1]) + 1)


def spmd_worker(rank, world, cases):
    """Each case ``(mesh shape, loss name, data)`` whose mesh spans
    ``world`` ranks: this rank's (data, fsdp) rows of ``data`` through the
    wrapper under the mesh, then its backward.  Returns {index: (loss,
    (data, fsdp) index, tensor index, dh of the rank's rows, dW)}."""
    import math

    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.parallel import (
        MeshConfig, make_mesh, use_mesh)
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.parallel.mesh import (
        axis_rank, dp_rank, dp_size)

    out = {}
    meshes = {}
    for i, (shape, name, data) in enumerate(cases):
        if math.prod(shape) != world:
            continue
        mesh = meshes.get(shape) or meshes.setdefault(shape, make_mesh(MeshConfig(*shape)))
        rows = dp_rows(data["h"].shape[0], dp_size(mesh), dp_rank(mesh))
        h = torch.from_numpy(data["h"][rows]).requires_grad_(True)
        w = torch.from_numpy(data["w"]).requires_grad_(True)
        tmat = torch.from_numpy(data["tmat"][rows])
        lab, lab_ce = (torch.from_numpy(data[k][rows]) for k in ("labels", "ce_labels"))
        with use_mesh(mesh):
            loss = spmd_loss(name, h, w, tmat, lab, lab_ce)
        loss.backward()
        out[i] = (loss.item(), dp_rank(mesh), axis_rank(mesh, "tensor"), h.grad.clone(), w.grad.clone())
    return out


def kd_cli_worker(rank, world, argv):
    """``cli/train_online_kd.py``'s main on this rank."""
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli import train_online_kd

    train_online_kd.main(argv)


def tensor_plan_worker(rank, world):
    """The tiny student sharded over a (1, 1, world) mesh: {name:
    (placements over the mesh, the local shape)} of every parameter."""
    from torch.distributed.tensor import DTensor

    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch import configs as pc
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.models import LlavaOnevision
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.parallel import (
        MeshConfig, make_mesh, shard_params)

    model = LlavaOnevision(pc.llava_onevision_tiny())
    shard_params(model, make_mesh(MeshConfig(1, 1, world)))
    return {n: (list(p.placements), tuple(p.to_local().shape)) if isinstance(p, DTensor) else (None, None)
            for n, p in model.named_parameters()}
