"""Readings that set a cell's limits: the control and the faults, and the
program's forward readings.

    python portbench/control.py --workload <cell> --seeds 101 102 103
    python portbench/control.py --workload <cell> --seeds 101 ... 112 --forward --control 3

For each seed, on the card, at the cell's own size, with the cell's weights
and first optimizer step's inputs:

* the reference in float32, the yardstick;
* the control: the same reference computed one precision below the
  configuration's bf16, every product's operands rounded to float8 e4m3
  (``reference.llava_onevision``'s ``precision="fp8"``), the teacher's
  forward and head included, put in the program's place: its gaps (after
  one step) against the yardstick;
* the "half the batch" fault: the first half of the step's micro-batches
  alone, the mean taken over them (read from the float32 run as it goes):
  its loss_gap and grad_gap;
* the "altered" fault: the first leaf's gradient doubled where the step
  produces it, worked out from the float32 run's gradient norms: its
  grad_gap;
* the "teacher" fault (a KD cell): the teacher's logits rolled by one
  vocabulary column where they are produced, worked out from the float32
  run's compared rows: its teacher_gap.

(A step that leaves the state unchanged reads change_gap 1, and teacher
logits left at zero read teacher_gap 1, by definition; they need no run.)

``--forward`` reads what the forward of step 1 decides (loss_gap,
loca_gap, teacher_gap): the program's first step, as a run of the cell
takes it, against the float32 reference's forward, and, for the first
``--control`` seeds, the control's forward and the teacher fault.  Prints
one JSON line a seed.  The benchmark's own runs do not run this.
"""

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path.insert(0, str(HERE.parent))

from portbench import run  # noqa: E402


def _cell(cell_name: str, data: Path):
    cell = run.load("workloads", cell_name, data)
    config, job = run.load("configs", cell["config"], data), run.load("traffic", cell["traffic"], data)
    return cell, config, job, importlib.import_module(f"portbench.reference.{config['reference']}")


def _loader(config: dict, seed: int, device):
    import torch

    from portbench import weights as seeded

    dtype = getattr(torch, config["dtype"])
    return lambda stream, sink: seeded.generate(config[stream], seed, stream, device, sink, dtype)


def _teacher_fault(exact: dict) -> dict:
    rolled = {"loss": exact["loss"], "teacher": [t.roll(1, dims=-1) for t in exact["teacher"]]}
    return run.gaps(rolled, {"loss": exact["loss"], "teacher": exact["teacher"]})


def _row_spread(prog: dict, exact: dict) -> list:
    """The quartiles and the largest of the compared teacher rows' gaps."""
    import torch

    g = torch.cat([((p - r).norm(dim=-1) / r.norm(dim=-1)) for p, r in zip(prog["teacher"], exact["teacher"])])
    return [g.quantile(q).item() for q in (0.25, 0.5, 0.75)] + [g.max().item()]


def readings(cell_name: str, seed: int, device, data: Path = HERE) -> dict:
    from portbench.traffic import Traffic

    _, config, job, ref = _cell(cell_name, data)
    load = _loader(config, seed, device)
    out, t0 = {"workload": cell_name, "seed": seed}, time.perf_counter()
    exact = ref.train(config, job, Traffic(job, config, seed), 1, device, "float32", load=load, log=run.log,
                      half_probe=True)
    low = ref.train(config, job, Traffic(job, config, seed), 1, device, "fp8", load=load, log=run.log)
    out["control"] = run.gaps(low, exact)
    one = {"loss": exact["loss"], "grad": exact["grad"]}
    out["half"] = run.gaps({"loss": [exact["half_loss"]], "grad": exact["half_grad"]}, one)
    first = next(iter(exact["grad"]))
    altered = {n: g * 2 if n == first else g for n, g in exact["grad"].items()}
    out["altered"] = run.gaps({"loss": exact["loss"], "grad": altered}, one)
    if "teacher" in exact:
        out["teacher"] = _teacher_fault(exact)
    out["seconds"] = time.perf_counter() - t0
    return out


def forward_readings(cell_name: str, seed: int, device, control: bool, data: Path = HERE) -> dict:
    import torch

    from portbench import system as port
    from portbench.traffic import Traffic

    _, config, job, ref = _cell(cell_name, data)
    out, t0 = {"workload": cell_name, "seed": seed}, time.perf_counter()
    tr = Traffic(job, config, seed)
    ref.set_float32_exact()  # as a run of the cell sets it
    sut = port.System(config, job, seed, device)
    prog = run.first_steps(sut, config, tr, 1, seed, device)
    sut.free()
    del sut
    if device.type == "cuda":
        torch.cuda.empty_cache()
    first = {k: prog[k] for k in ("loss", "loca", "teacher") if k in prog}
    load = _loader(config, seed, device)
    exact = ref.train(config, job, tr, 1, device, "float32", load=load, log=run.log, backward=False)
    out["program"] = run.gaps(first, exact)
    out["loca"] = {"program": first.get("loca"), "reference": exact.get("loca")}
    if "teacher" in exact:
        out["program_rows"] = _row_spread(first, exact)
    if control:
        low = ref.train(config, job, tr, 1, device, "fp8", load=load, log=run.log, backward=False)
        out["control"] = run.gaps(low, exact)
        out["loca"]["control"] = low.get("loca")
        if "teacher" in exact:
            out["control_rows"] = _row_spread(low, exact)
        if "teacher" in exact:
            out["teacher"] = _teacher_fault(exact)
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--forward", action="store_true", help="the forward's readings, the program's among them")
    p.add_argument("--control", type=int, default=None, help="with --forward: the control on the first N seeds")
    args = p.parse_args(argv)
    run.cache_dirs()
    import torch

    if not torch.cuda.is_available():
        run.log("needs a CUDA device")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    n_control = len(args.seeds) if args.control is None else args.control
    for i, seed in enumerate(args.seeds):
        got = (forward_readings(args.workload, seed, device, i < n_control) if args.forward
               else readings(args.workload, seed, device))
        print(json.dumps(got), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
