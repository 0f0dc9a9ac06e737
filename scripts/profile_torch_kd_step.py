"""Where the time of the PyTorch port's KD train step goes, on one CUDA GPU.

    python scripts/profile_torch_kd_step.py [--steps 5] [--layers N] [--kd_mode M --phase P]
        [--loca_faithful_indexing] [--int8_teacher] [--determinism] [--parent DIR]

Builds a KD step that ``chip_smoke.py`` drives (``--kd_mode`` and
``--phase``, by default double_trouble phase 3; double_trouble phase 1, the
KD CLI's default, feature_based and, with ``--loca_faithful_indexing``, the
faithful LoCa also run there; the vocabulary losses on the fused kernels),
or with ``--kd_mode baseline`` the baseline_depth step of ``cli/train.py``
(the student alone, masked CE through K5/K6, lr 2e-5, no teacher), the
0.5B student
against the frozen bf16 LLaVA-OneVision-7B teacher (with ``--int8_teacher``
quantized in place as ``chip_smoke.py``'s ``[kd8]`` quantizes it:
int8_full, the int8 embedding and the vocab-major int8 head, so its
projections run K12 and its logits K10), both at full width and
depth unless ``--layers`` cuts them, seeded random weights, A=2 x B=1 at
the SUNRGBD 530x730 frame, with the mode's freeze mask; runs ``--steps``
unprofiled steps, then:

* times the teacher's part of one micro-batch with CUDA events: its forward
  under ``no_grad`` and the float32 teacher-logit product (not for the
  baseline);
* profiles one whole step with ``torch.profiler`` and sums the device time
  of every kernel by group (the port's kernels by name, cuBLAS GEMMs,
  AdamW, the rest), against the mean wall time of the unprofiled steps
  after the first two (host clock; the profiler slows the host down).

``--parent DIR`` (another checkout of the port, e.g. the parent commit
unpacked by ``git archive``) then profiles three more steps, with DIR's
flash and K5-K12 kernels (``chip_smoke.PARENT_LAUNCHERS``), DIR's
again and this checkout's, and prints each step's device kernel time and
its kernel groups (flash, the vocabulary losses K5-K11, int8) and peak
memory: a comparison that the host's noise does not reach.

``--determinism`` asks instead whether the step is bit-reproducible on one
card: ``--steps`` steps from a fresh student of the same seed, twice in this
process, with the bits of every step's loss and terms and of every float32
master compared (the differing masters counted by module); then twice more
under ``torch.use_deterministic_algorithms(True, warn_only=True)``, printing
each operation that PyTorch reports as nondeterministic, whether those two
runs agree, and whether they agree with the first.
(``CUBLAS_WORKSPACE_CONFIG`` is set for all four runs, as deterministic
mode asks of cuBLAS.)

Prints the card's name and power limit first.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import hashlib
import os
import subprocess
import sys
import time
import warnings

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli import (  # noqa: E402
    common,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.configs import (  # noqa: E402
    TrainConfig,
    kd_loss_config_for,
    llava_onevision_0_5b,
    llava_onevision_7b,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.train import (  # noqa: E402
    KDModels,
    TrainState,
    make_optimizer,
    make_train_step,
    step as kd_step,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.utils.synthetic import (  # noqa: E402
    synthetic_kd_batch,
)

ACCUM = 2
# (group, substrings of the kernel's demangled name), first match wins.
GROUPS = (
    # K3: csrc/flash_gqa_sm90.cuh (kdss_gqa90; the mma.sync flash_fwd_kernel before)
    ("flash forward D=128 (teacher K3)", ("kdss_gqa90::fwd_kernel<128", "flash_fwd_kernel<128")),
    # K1 at D = 72: csrc/flash_fwd_sm90.cu (the mma.sync kernel before)
    ("flash forward D=72 (K1)", ("kdss_fwd90", "flash_fwd_kernel<72")),
    ("flash forward D=64 (student K3)", ("kdss_gqa90::fwd_kernel<64", "flash_fwd_kernel")),
    # K2 at D = 72: csrc/flash_bwd_d72_sm90.cu's dq and dk/dv kernels
    ("flash backward D=72 (K2)", ("kdss_bwd72", "flash_bwd_dq_kernel<72", "flash_bwd_dkv_kernel<72")),
    # K4 at D = 64: csrc/flash_bwd_sm90.cu's dq, dk/dv and reduce kernels
    ("flash backward D=64 (K4)", ("kdss_bwd90",)),
    # K5 and K7: csrc/fused_ce.cu's and csrc/fused_kl.cu's forward sweeps on
    # csrc/kdss_vocab_sm90.cuh, named by their epilogue policies
    # (kdss_ce_fwd90::LseGoldEpi, kdss_kl_fwd90::StatsEpi), and their
    # combines; a parent's mma.sync ce_fwd_kernel and kl_fwd_kernel.  Before
    # K6, K8 and K11: a sweep's name holds kdss_vocab90 too.
    ("fused CE forward (K5)", ("ce_fwd",)),
    ("temperature KL forward (K7)", ("kl_fwd",)),
    # K6 and K8 on csrc/kdss_vocab_sm90.cuh: the ds sweep and the products
    # are named by the loss's ds policy (kdss_ce90::DsEpi, kdss_kl90::DsEpi);
    # a parent's mma.sync dh and dW kernels by CERows / KLRows
    ("fused CE backward (K6)", ("kdss_ce90", "CERows")),
    ("temperature KL backward (K8)", ("kdss_kl90", "KLRows")),
    ("dh split reductions of a parent's mma.sync K6 and K8", ("reduce_dh",)),
    # K11/K9: csrc/fused_loca_ce.cu's sweeps, combines and products on
    # csrc/kdss_vocab_sm90.cuh (named by its epilogue policies in
    # kdss_loca_ce; a parent's products may bear no policy's name)
    ("LoCa + CE (K11), LoCa (K9)", ("loca_", "LocaRows", "kdss_vocab90")),
    # K12's quantize pass and GEMM (the int8 teacher), before cuBLAS's "gemm"
    ("w8a8 GEMM K12 (int8 teacher)", ("kdss_int8",)),
    ("int8-head teacher logits K10", ("kdss_tmat",)),
    ("GEMMs (cuBLAS)", ("nvjet", "gemm", "xmma", "cutlass", "sm90_", "cublas")),
    ("AdamW (foreach)", ("multi_tensor_apply",)),
)


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other (elementwise, casts, norms, reductions, copies)"


def cut(cfg, layers):
    if layers is None:
        return cfg
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, num_hidden_layers=layers),
        text=dataclasses.replace(cfg.text, num_hidden_layers=layers))


def event_ms(fn, iters=3) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def run_steps(fresh, tb, steps):
    """``steps`` steps from a fresh student: (per-step metric bits, a digest
    of each float32 master after the last step)."""
    state, step = fresh()
    trace = []
    for _ in range(steps):
        state, metrics = step(state, None, tb)
        trace.append({k: v.float().cpu().numpy().tobytes().hex() for k, v in sorted(metrics.items())})
    torch.cuda.synchronize()
    digests = {name: hashlib.sha256(m.detach().cpu().numpy().tobytes()).hexdigest()
               for name, m in state.optimizer.masters.items()}
    return trace, digests


def compare(tag, a, b) -> None:
    """Print whether two runs' metrics and masters are bit-identical, and
    the masters that differ, counted by top-level module."""
    for i, (x, y) in enumerate(zip(a[0], b[0])):
        print(f"[determinism] {tag}, step {i + 1}: metrics bit-identical: {x == y}"
              + ("" if x == y else f" ({ {k: (x[k], y[k]) for k in x if x[k] != y[k]} })"), flush=True)
    differ = [n for n in a[1] if a[1][n] != b[1][n]]
    roots = collections.Counter(n.split(".", 1)[0] for n in differ)
    print(f"[determinism] {tag}: float32 masters bit-identical after {len(a[0])} steps: "
          f"{len(a[1]) - len(differ)} of {len(a[1])}; differing by module: {dict(roots)}; "
          f"first differing: {differ[:6]}", flush=True)


def determinism(fresh, tb, steps) -> int:
    """Two runs from the same seed, then two under deterministic mode."""
    first = run_steps(fresh, tb, steps)
    second = run_steps(fresh, tb, steps)
    compare("two runs", first, second)
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        third = run_steps(fresh, tb, steps)
        fourth = run_steps(fresh, tb, steps)
    torch.use_deterministic_algorithms(False)
    ops = sorted({str(w.message).split(" does not have a deterministic")[0] for w in caught
                  if "deterministic" in str(w.message)})
    print(f"[determinism] under use_deterministic_algorithms(True, warn_only=True): "
          f"{len(ops)} nondeterministic op(s) reported: {ops}", flush=True)
    compare("two runs in deterministic mode", third, fourth)
    compare("deterministic mode against the first run", first, third)
    return 0


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=5,
                   help="unprofiled steps before the profiled one (at least 3)")
    p.add_argument("--layers", type=int, default=None, help="cut both models to this many layers")
    p.add_argument("--kd_mode", type=str, default="double_trouble",
                   choices=["logit_based", "feature_based", "double_trouble", "baseline"],
                   help="baseline: cli/train.py's baseline_depth step (the student alone, no teacher)")
    p.add_argument("--phase", type=int, default=3, choices=[1, 2, 3])
    p.add_argument("--loca_faithful_indexing", action="store_true")
    p.add_argument("--int8_teacher", action="store_true",
                   help="quantize the teacher in place as chip_smoke.py's [kd8] does")
    p.add_argument("--determinism", action="store_true",
                   help="compare the bits of two runs, then run under deterministic mode")
    p.add_argument("--parent", default=None,
                   help="another checkout of the port (e.g. the parent commit unpacked by git archive): "
                        "profile the step again with its kernels, in turns with this one's")
    args = p.parse_args()
    if args.steps < 3:
        p.error("--steps must be at least 3")
    if args.determinism:  # before the first cuBLAS call
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    dev = common.setup_device(argparse.Namespace(cpu=False))

    baseline = args.kd_mode == "baseline"
    if baseline and (args.int8_teacher or args.loca_faithful_indexing):
        p.error("--kd_mode baseline has no teacher and no LoCa")
    scfg, tcfg = cut(llava_onevision_0_5b(), args.layers), cut(llava_onevision_7b(), args.layers)
    teacher = None if baseline else common.init_or_load_params(tcfg, None, seed=1, attn_impl="flash", device=dev,
                                                               dtype=torch.bfloat16)
    if args.int8_teacher:
        from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops import int8

        int8.quantize_model_int8(teacher, include_vision=True, include_embed_head=True)
    batch = synthetic_kd_batch(scfg, 1, seq_len=3072, orig_sizes=[(530, 730)], accum=ACCUM, seed=3)
    tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()
          if not (baseline and k.startswith("teacher_"))}
    if baseline:  # cli/train.py's step and learning rate
        lr, phase = 2e-5, 0
        cfg = TrainConfig(kd_mode="baseline", ce_impl="fused", accumulate_grad_batches=ACCUM, learning_rate=lr,
                          cosine_t_max=0)
    else:
        lr, phase = 1e-5, args.phase
        loss_cfg = dataclasses.replace(kd_loss_config_for(args.kd_mode),
                                       loca_faithful_indexing=args.loca_faithful_indexing)
        cfg = TrainConfig(kd_mode=args.kd_mode, phase=phase, loss=loss_cfg, ce_impl="fused",
                          accumulate_grad_batches=ACCUM, learning_rate=lr, cosine_t_max=0)
    lc = cfg.loss

    def fresh():
        """A student from seed 0, its optimizer state and its train step."""
        torch.cuda.empty_cache()
        student = common.init_or_load_params(scfg, None, seed=0, attn_impl="flash", device=dev,
                                             dtype=torch.bfloat16, trainable=True)
        state = TrainState(student, make_optimizer(student, lr, kd_mode=args.kd_mode, phase=phase))
        return state, make_train_step(KDModels(student, teacher), cfg)

    if args.determinism:
        return determinism(fresh, tb, args.steps)
    state, step = fresh()
    student = state.model
    times = []
    for _ in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, None, tb)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = sum(times[2:]) / len(times[2:])
    print(f"[steps] unprofiled step ms: {', '.join(f'{t:.1f}' for t in times)}; mean after the first two "
          f"{step_ms:.1f} ms", flush=True)

    micro = {k: v[0] for k, v in tb.items()}
    vocab = student.language_model.embed_tokens.weight.shape[0]
    if not baseline:
        t_logits_ms = event_ms(lambda: kd_step._teacher_logits(teacher, micro, vocab, lc.temperature))
    if args.int8_teacher:  # the logits are K10's, inside the profile's K10 group
        print(f"[teacher] int8 teacher per micro-batch: forward + logits {t_logits_ms:.3f} ms (CUDA events)",
              flush=True)
    elif not baseline:
        with torch.no_grad():
            hidden = kd_step._forward_hidden(teacher, micro, "teacher")[0]
            th = hidden.reshape(-1, hidden.shape[-1])
            wt = teacher.language_model.lm_head.weight[:vocab]
            tmat_ms = event_ms(lambda: torch.mm(th, wt.T, out_dtype=torch.float32))
            del hidden, th
        print(f"[teacher] per micro-batch: forward + logits {t_logits_ms:.3f} ms, of which the f32 "
              f"logit product [{3072}, {vocab}] {tmat_ms:.3f} ms (CUDA events)", flush=True)

    def profiled_step(state):
        """One step under torch.profiler: (state, metrics, device ms by group,
        kernels by group, the "other" kernels by name, annotation ranges,
        peak memory in bytes)."""
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.reset_peak_memory_stats(dev)
        with torch.profiler.profile(activities=acts) as prof:
            state, metrics = step(state, None, tb)
            torch.cuda.synchronize()
        groups, count, other = collections.Counter(), collections.Counter(), collections.Counter()
        ranges = collections.Counter()
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            ms = e.time_range.elapsed_us() / 1e3
            # kernels only: not the device-side ranges of annotations such as
            # "Optimizer.step#AdamW.step", which overlap the kernels inside them
            if getattr(e, "is_user_annotation", False):
                ranges[e.name[:90]] += ms
                continue
            g = group_of(e.name)
            groups[g] += ms
            count[g] += 1
            if g.startswith("other"):
                other[e.name[:90]] += ms
        return state, metrics, groups, count, other, ranges, torch.cuda.max_memory_allocated(dev)

    state, metrics, groups, count, other, ranges, peak = profiled_step(state)
    busy = sum(groups.values())
    what = "baseline_depth" if baseline else f"{args.kd_mode} phase {args.phase}"
    teacher_tag = ", int8 teacher" if args.int8_teacher else ""
    print(f"[profile] {what}{teacher_tag}: one step (A={ACCUM} x B=1), "
          f"loss {metrics['loss'].item():.6f}: device kernel time "
          f"{busy:.1f} ms, {100 * busy / step_ms:.1f}% of the unprofiled step; peak memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    if busy == 0:
        print("[profile] the profiler saw no device kernels", flush=True)
        return 1
    for g, ms in groups.most_common():
        print(f"[profile] {g}: {ms:.2f} ms ({100 * ms / busy:.1f}% of device time), {count[g]} kernels",
              flush=True)
    for name, ms in other.most_common(12):
        print(f"[profile]   other: {ms:.2f} ms  {name}", flush=True)
    for name, ms in ranges.most_common(5):
        print(f"[profile] annotation range, not counted: {ms:.2f} ms  {name}", flush=True)
    if args.parent is not None:
        # the same step's device kernel time with the parent's launchers
        # (chip_smoke.PARENT_LAUNCHERS), in turns with this checkout's:
        # change (above), parent, parent, change
        import chip_smoke

        parent = chip_smoke.load_parent(args.parent)
        runs = [(busy, groups, peak)]
        for use_parent in (True, True, False):
            with chip_smoke.parent_kernels(parent) if use_parent else contextlib.nullcontext():
                state, _, g, _, _, _, pk = profiled_step(state)
            runs.append((sum(g.values()), g, pk))
        print("[parent] device kernel time of a step, change / parent / parent / change: "
              + " / ".join(f"{b:.1f}" for b, _, _ in runs) + " ms; peak memory "
              + " / ".join(f"{pk / 2**30:.2f}" for _, _, pk in runs) + " GiB", flush=True)
        for name, _ in GROUPS:
            if name.startswith(("GEMMs", "AdamW")) or not any(g[name] for _, g, _ in runs):
                continue
            print(f"[parent] {name}: " + " / ".join(f"{g[name]:.2f}" for _, g, _ in runs) + " ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
