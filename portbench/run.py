"""The benchmark of the PyTorch/CUDA port, one cell a run.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Finds the cell's files by name (``workloads/<cell>.json`` names its
configuration, ``configs/<name>.json``, and its traffic,
``traffic/<name>.json``), builds the port's models on the card from the
seed, and then:

1. set-up: draws the weights, builds the port's training step, and runs the
   cell's first ``check_steps`` optimizer steps (which build and warm every
   kernel and shape of the window), reading what ``correct`` compares: each
   step's loss and LoCa term, the teacher's logits at rows drawn from the
   seed, each trained leaf's first gradient (from AdamW's state after one
   step) and its change over those steps;
2. the window: whole optimizer steps on fresh inputs until ``--seconds``
   have passed; ``train_samples_per_s`` is their samples over their time;
3. with ``--trace 1``, one more step under ``torch.profiler`` for the
   per-layer metrics (``metrics/<name>.py``) and the breakdown;
4. reads the peak memory, frees the program, and follows the same first
   steps with the plain float32 reference (``reference/``), on the same
   weights and inputs; compares, and prints the numbers beside their limits.

The last line of standard output is the result as one JSON object.  Exits 2
without a result when there is no CUDA card or fewer than the cell asks
for, 3 when a JAX module was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# run as a script, the first entry is portbench/ itself, whose module names
# would shadow the standard library's: import from the checkout's root
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path.insert(0, str(ROOT))

# Modules that may not be loaded in this process, by whole top-level name.
JAX_NAMES = frozenset({"jax", "jaxlib", "flax", "optax", "kdss",
                       "knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu"})
# the numbers ``correct`` may compare; a cell's ``limits`` name its own
CHECKS = ("loss_gap", "grad_gap", "change_gap", "loca_gap", "teacher_gap")
# a leaf whose reference gradient is below this share of the median leaf's
# moves by round-off alone under AdamW, and is left out of change_gap
QUIET_GRAD = 1e-3


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load(kind: str, name: str, data: Path = HERE) -> dict:
    path = data / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no {kind[:-1] if kind.endswith('s') else kind} named {name!r} ({path})")
    return json.loads(path.read_text())


def jax_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & JAX_NAMES)


def cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the port
    builds its kernels into build/kernels/ itself)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers ``correct`` compares, program against reference: the
    worst relative gap of a step's loss and of its LoCa term; of a trained
    leaf's first-gradient norm and of its change's norm, each against the
    larger of the reference's norm of that leaf and of the median leaf
    (leaves that do not move in the reference left out of the change); of
    a compared row of the teacher's logits, against the reference's norm
    of that row.  A leaf that one side trains and the other does not, and a
    micro-batch whose teacher rows one side lacks, read 1."""
    out = {"loss_gap": max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))}
    if "loca" in prog and "loca" in ref:
        out["loca_gap"] = max(abs(p - r) / abs(r) for p, r in zip(prog["loca"], ref["loca"]))
    if "teacher" in prog and "teacher" in ref:
        rows = [1.0 if p is None or p.shape != r.shape else ((p - r).norm(dim=-1) / r.norm(dim=-1)).max().item()
                for p, r in zip(prog["teacher"], ref["teacher"])]
        out["teacher_gap"] = max(rows + [1.0] * abs(len(prog["teacher"]) - len(ref["teacher"])))
    if "grad" not in prog or "grad" not in ref:
        return out
    names = set(ref["grad"])
    missing = names.symmetric_difference(prog["grad"])
    g_med = statistics.median(ref["grad"].values())
    out["grad_gap"] = max([abs(prog["grad"][n] - ref["grad"][n]) / max(ref["grad"][n], g_med)
                           for n in names - missing] + [1.0] * len(missing))
    moving = [n for n in names - missing if ref["grad"][n] >= QUIET_GRAD * g_med]
    if "change" in prog and "change" in ref:
        c_med = statistics.median(ref["change"][n] for n in moving)
        out["change_gap"] = max([abs(prog["change"][n] - ref["change"][n]) / max(ref["change"][n], c_med)
                                 for n in moving] + [1.0] * len(missing))
    return out


class TraceContext:
    """What a per-layer metric reads: the profiled step's trace and kernel
    groups, its micro-batches' samples and the port's launch counts in it,
    the window's steps, seconds, samples and required operations."""

    def __init__(self, config, job, seq_bucket, trace, micro_batches, launches, window, samples_per_step):
        from portbench import kernel_trace

        self.config, self.job, self.seq_bucket = config, job, seq_bucket
        self.trace, self.micro_batches, self.launches = trace, micro_batches, launches
        self.window, self.samples_per_step = window, samples_per_step
        self.groups = kernel_trace.ms_by_group(trace)


def first_steps(sut, config: dict, tr, steps: int, seed: int, device) -> dict:
    """The program's first ``steps`` optimizer steps, on the traffic's first
    inputs, and what ``correct`` compares from them."""
    import contextlib

    import torch

    from portbench import weights as seeded

    prog: Dict[str, object] = {"loss": []}
    for k in range(steps):
        rows = (sut.teacher_rows(lambda a: tr.check_rows(0, a)) if k == 0 and sut.teacher is not None
                else contextlib.nullcontext())
        with rows as kept:
            metrics = sut.step(sut.batch(tr.make(k, device)))
        prog["loss"].append(metrics["loss"].item())
        if "loca" in metrics:
            prog.setdefault("loca", []).append(metrics["loca"].item())
        if kept is not None:
            prog["teacher"] = kept
        log(f"[setup] check step {k + 1} done at {time.perf_counter() - T0:.3f} s")
        if k == 0:
            prog["grad"] = sut.first_grad_norms()
    masters, change = sut.masters, {}

    def change_of(name, x):
        if name in masters:
            change[name] = (masters[name] - x.float()).norm().item()

    with torch.no_grad():
        seeded.generate(config["student"], seed, "student", device, change_of, getattr(torch, config["dtype"]))
    prog["change"] = change
    return prog


def metric_modules(directory: Path = HERE / "metrics"):
    """(name, module) of every per-layer metric file in ``directory``."""
    import importlib.util

    for path in sorted(directory.glob("*.py")):
        if path.name.startswith("_"):
            continue
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        yield path.stem, mod


def main(argv=None, data: Path = HERE, device=None) -> int:
    """``data`` and ``device`` are for the CPU tests: other data files, the
    CPU without the look for a card."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = load("workloads", args.workload, data)
    config, job = load("configs", cell["config"], data), load("traffic", cell["traffic"], data)
    cache_dirs()

    import torch

    from portbench import kernel_trace, system as port, weights as seeded
    from portbench.counts import step as counts
    from portbench.traffic import Traffic

    ref = importlib.import_module(f"portbench.reference.{config['reference']}")
    port.System.import_port()
    log(f"[setup] imports done at {time.perf_counter() - T0:.3f} s")
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            log(f"needs {cell['chips']} CUDA device(s); found "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    torch.set_num_threads(4)
    ref.set_float32_exact()  # as the port's CLIs set it (cli/common.py::setup_device)
    on_card = device.type == "cuda"
    dtype = getattr(torch, config["dtype"])
    seq_bucket = job["seq_bucket"]
    check_steps = cell["check_steps"]
    tr = Traffic(job, config, args.seed)

    # 1. set-up: the program, its first steps (the check's readings)
    sut = port.System(config, job, args.seed, device)
    log(f"[setup] program built at {time.perf_counter() - T0:.3f} s")
    prog = first_steps(sut, config, tr, check_steps, args.seed, device)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T0
    log(f"[setup] {setup_s:.3f} s; check steps' losses {prog['loss']}")

    # 2. the window
    k, steps, samples, failed, flops, ends = check_steps, 0, 0, 0, 0.0, []
    t_start = time.perf_counter()
    while True:
        inputs = tr.make(k, device)
        loss = sut.step(sut.batch(inputs))["loss"].item()
        ends.append(time.perf_counter() - t_start)
        n = tr.samples_per_step
        steps, samples, k = steps + 1, samples + n, k + 1
        failed += 0 if math.isfinite(loss) else n
        flops += counts.step_flops(config, job, seq_bucket, [s for row in inputs.samples for s in row])
        elapsed = time.perf_counter() - t_start
        if elapsed >= args.seconds:
            break
    window = {"steps": steps, "samples": samples, "seconds": elapsed, "flops": flops}
    log(f"[window] {steps} steps, {samples} samples in {elapsed:.3f} s; steps end at {ends}")

    # 3. the traced step
    per_layer, breakdown, busy = {}, None, None
    if args.trace:
        inputs = tr.make(k, device)
        batch = sut.batch(inputs)
        before = sut.counters()
        acts = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if on_card else [])
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(kernel_trace.STEP_ANNOTATION):
                sut.step(batch)
                if on_card:
                    torch.cuda.synchronize()
        launches = {n: c - before[n] for n, c in sut.counters().items()}
        t_read = time.perf_counter()
        trace = kernel_trace.from_profiler(prof)
        del prof
        ctx = TraceContext(config, job, seq_bucket, trace, inputs.samples, launches, window, tr.samples_per_step)
        for name, mod in metric_modules():
            value = mod.read(ctx)
            if value is not None:
                per_layer[name] = {"value": value, "unit": mod.UNIT}
        busy = (kernel_trace.busy_us(trace) / 1e6, kernel_trace.span_us(trace) / 1e6)
        breakdown = {"device_ops": [[n, s] for n, s in kernel_trace.top_kernels(trace)],
                     "idle_gaps": [[n, s] for n, s in kernel_trace.idle_by_host_op(trace)]}
        log(f"[trace] read in {time.perf_counter() - t_read:.3f} s: {len(trace.kernels)} kernels, "
            f"{len(trace.host)} host events; groups (ms): {json.dumps(ctx.groups)}; launches {json.dumps(launches)}")
        log(f"[trace] top 'other' kernels (ms): {json.dumps(kernel_trace.top_other(trace))}")
        stray = kernel_trace.stray_port_kernels(trace)
        if stray:
            log(f"[trace] WARNING: the port's kernels in no named group: {stray}")

    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    if busy is not None:
        device_info.update(busy_s=busy[0], window_s=busy[1])
    found = jax_modules()
    if found:
        log(f"JAX modules loaded in this process: {found}")
        return 3

    # 4. the reference follows the first steps on the same weights and inputs
    sut.free()
    del sut
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    reference = ref.train(config, job, tr, check_steps, device, "float32",
                          load=lambda stream, sink: seeded.generate(config[stream], args.seed, stream, device,
                                                                    sink, dtype),
                          log=log)
    limits = cell["limits"]
    checks = gaps(prog, reference)
    if set(limits) - set(checks):
        raise SystemExit(f"no reading for the limits {sorted(set(limits) - set(checks))}")
    correct = failed == 0 and all(checks[c] <= limits[c] for c in limits)
    log(f"[reference] {time.perf_counter() - t_ref:.3f} s; losses {reference['loss']}")

    metrics = per_layer if args.trace else {
        "train_samples_per_s": {"value": samples / elapsed, "unit": "samples/s"},
        "peak_mem_gib": {"value": peak / 2**30, "unit": "GiB"},
        "setup_s": {"value": setup_s, "unit": "s"},
    }
    result = {"correct": correct, "attempted": samples, "failed": failed, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {c: {"value": checks[c], "limit": limits[c]} for c in limits}
    for c in limits:
        log(f"check {c} {checks[c]!r} limit {limits[c]!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
