"""Plan the phase-3 KD step of the PyTorch port at real 7B-teacher scale on a
mesh of d x f x t ranks and print the per-rank memory table (the port's
counterpart of ``scripts/aot_7b.py``).

No weights are materialized: the planner (``parallel/aot.py``) runs one step
on fake tensors as rank 0 of a process group of the ``fake`` backend, which
this script starts (world size d * f * t), and counts every byte the step
would allocate on the card.  The table gives, per configuration, each
model's parameter bytes on a rank under the rule table (the JAX
arithmetic) and as ``shard_params`` places them, the bytes resident when
the step starts, the step's own peak above them, the estimate, and whether
it fits one H100's 80 GiB.  The last line of the output is one JSON object.

Usage (on the card's machine, where the kernel routes are traced; ``--cpu``
traces the CPU routes and runs anywhere):
  python scripts/torch_aot_7b.py                     # full depth, int8_full teacher, mesh 1,2,4
  python scripts/torch_aot_7b.py --layers 2          # width-exact, depth-reduced
  python scripts/torch_aot_7b.py --mesh 1,8,1 --quant none
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GIB = 1 << 30
# One H100's device memory.
CARD_BYTES = 80 * GIB


def start_fake_group(world_size: int) -> None:
    """Rank 0 of a ``fake``-backend process group of ``world_size`` ranks
    (its collectives return at once), unless a group is up already."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def plan(mesh_cfg, quant: str, embed_quant: str, *, layers=None, seq_len=3072, accum=2,
         per_dp_batch=1, device="cuda") -> dict:
    """One row of the table: the planner's stats for the configuration, the
    models' rule-table and placed parameter bytes on rank 0."""
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.parallel import aot

    scfg, tcfg = aot.teacher_7b_student_05b(layers=layers)
    student, teacher = aot.meta_models(scfg, tcfg, quant, embed_quant)
    params = {
        "student_rule": aot.sharded_param_bytes(student, mesh_cfg),
        "teacher_rule": aot.sharded_param_bytes(teacher, mesh_cfg),
        # under a mesh the student's sharded parameters are its float32 masters
        "student_placed": aot.placed_param_bytes(student.float() if mesh_cfg.num_devices > 1 else student,
                                                 mesh_cfg),
        "teacher_placed": aot.placed_param_bytes(teacher, mesh_cfg),
        "teacher_whole": sum(p.numel() * p.element_size() for p in teacher.parameters()),
    }
    t0 = time.perf_counter()
    _, stats = aot.aot_compile_kd_step(
        scfg, tcfg, mesh_cfg, seq_len=seq_len, per_dp_batch=per_dp_batch, accum=accum,
        teacher_quant=quant, teacher_embed_quant=embed_quant, device=device)
    return {
        "mesh": list(mesh_cfg.shape), "layers": layers or "full", "teacher_quant": quant,
        "teacher_embed_quant": embed_quant, "seq_len": seq_len, "accum": accum,
        "global_batch": per_dp_batch * mesh_cfg.data * mesh_cfg.fsdp,
        "trace_seconds": round(time.perf_counter() - t0, 1), "params": params, **stats,
        "fits_80gib": stats["per_chip_hbm_estimate"] < CARD_BYTES,
    }


def table(rows) -> str:
    head = ("config", "mesh", "student rule/placed GiB", "teacher rule/placed GiB", "arguments GiB",
            "temps GiB", "estimate GiB", "fits 80 GiB")
    lines = [" | ".join(head)]
    for r in rows:
        p = r["params"]
        lines.append(" | ".join((
            f"{r['teacher_quant']}+{r['teacher_embed_quant']} embed, {r['layers']} layers",
            "x".join(map(str, r["mesh"])),
            f"{p['student_rule'] / GIB:.3f}/{p['student_placed'] / GIB:.3f}",
            f"{p['teacher_rule'] / GIB:.3f}/{p['teacher_placed'] / GIB:.3f}",
            f"{r['argument_bytes'] / GIB:.3f}", f"{r['temp_bytes'] / GIB:.3f}",
            f"{r['per_chip_hbm_estimate'] / GIB:.3f}", "yes" if r["fits_80gib"] else "no")))
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--layers", type=int, default=None,
                    help="depth-reduce both models to N layers (widths stay real); default = full depth "
                         "(28 teacher / 24 student)")
    ap.add_argument("--mesh", type=str, default="1,2,4", help="data,fsdp,tensor (product = rank count)")
    ap.add_argument("--quant", choices=["none", "int8", "int8_full"], default="int8_full",
                    help="teacher quantization")
    ap.add_argument("--embed_quant", choices=["none", "int8"], default="none",
                    help="int8: the teacher's int8 token embedding and vocab-major int8 head")
    ap.add_argument("--seq_len", type=int, default=3072)
    ap.add_argument("--accum", type=int, default=2)
    ap.add_argument("--per_dp_batch", type=int, default=1)
    ap.add_argument("--cpu", action="store_true", help="trace the CPU routes (no card needed)")
    args = ap.parse_args()

    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.parallel.mesh import (
        parse_mesh,
    )

    mesh_cfg = parse_mesh(args.mesh)
    if mesh_cfg.num_devices > 1:
        start_fake_group(mesh_cfg.num_devices)
    row = plan(mesh_cfg, args.quant, args.embed_quant, layers=args.layers, seq_len=args.seq_len,
               accum=args.accum, per_dp_batch=args.per_dp_batch, device="cpu" if args.cpu else "cuda")
    print(table([row]), flush=True)
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
