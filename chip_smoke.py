"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (sm_90a, H100).

    python3 chip_smoke.py

Phases (any failure raises, and the exit code is non-zero):
  1. print the card's name and power limit; require CUDA;
  2. build the kernel library from the sources in this checkout
     (into build/kernels/, one nvcc per source, in parallel) and print the
     build time;
  3. hold each kernel against its plain PyTorch version at the
     main paths' shapes, in bf16 on the card (max abs error after an f32
     cast <= 2e-2, dW by a relative bound on its max norm, and every output
     by its relative Frobenius error <= 1e-2), show that these bounds fail
     a flash backward that drops delta and a fused CE backward that drops
     its softmax term, and time kernel, plain version and SDPA where it
     computes the same function;
  4. training path: 8 baseline_depth train steps (AdamW, lr 2e-5, A=2
     accumulated micro-batches of B=1) of the 0.5B depth student at full
     width and depth (seeded random weights, bf16 compute with float32
     master weights and AdamW state) on the SUNRGBD production frame,
     through cli/train.py's step; exact kernel launch counts, a finite and
     falling loss, that an update of ~lr moves the float32 master of a
     weight of magnitude ~0.02, the mean time of the 5 steps after 3
     warm-up steps, and peak memory; then the kernel path against the
     plain path at full width and 2+2 layers;
  5. serving path: greedy generation with the same student at full width
     and depth, with launch counts read around it; check the tokens and the
     prefill logits, and that the kernel path agrees with the plain path;
  6. int8 serving ([main8]): the same student quantized int8_full (its
     decoder and SigLIP projections w8a8 through K12, the tied head bf16),
     3 generate calls with exact launch counts, the prefill logits of the
     kernel path against the plain path, and their cosine to the bf16
     model's;
  7. KD paths, all against one frozen LLaVA-OneVision-7B teacher (bf16,
     seeded random weights, built once), the student on the depth stream
     and the teacher on the RGB stream, both at full width and depth,
     through cli/train_online_kd.py's step (AdamW, lr 1e-5, A=2 x B=1, a
     fresh student each): 6 double-trouble phase-3 steps, 6 phase-3 steps
     with the faithful LoCa ([kdF]: chunked_faithful_loca over the f32
     teacher logits, CE through K5/K6), then K9's path, the op API
     fused_loca_loss, forward and backward on one [kdF] micro-batch and
     held to K11's LoCa term there; 6 phase-1 steps
     (the KD CLI's default: temperature KL + NT-Xent, the language model
     frozen) and 4 feature_based steps; then ([kd8]) the same teacher
     quantized in place as the benchmark configures it (int8_full, the
     int8 embedding and the vocab-major int8 head, whose logits K10
     makes) and 6 more phase-3 steps; for each, exact launch counts, a
     finite and falling loss, the mean time of the steps after the first
     two, samples/s and peak memory; for phase 1 also that the float32
     masters of the vision tower and the projector moved and the frozen
     language model (the tied head included) did not, bit for bit; then
     the phase-3 KD loss and gradients on the kernel path against dense
     float32 LoCa + CE (with the bf16 teacher, with the faithful LoCa, and
     with the int8 teacher), and the
     phase-1 loss against dense float32 KL + NT-Xent, on the plain path at
     full width and 2+2 layers of each model (each loss and its KL term
     alone);
  8. [tiny]: the baseline and KD CLIs with --synthetic_data on the card
     without --real_model (the tiny configs: the CLIs choose the plain
     routes from their widths and head dims, and no kernel launches), one
     of them on the synthetic DAQUAR tree with the faithful LoCa;
  9. [eval]: the evaluator CLI (cli/evaluate_onevision.py) with the 0.5B
     student at full width and depth on a 21-row synthetic SUNRGBD split
     whose frames cycle through the four sensor sizes, at B=8 (a padded
     5-row tail) and B=1 with exact launch counts: the same rows, each
     row's prefill next-token logits and generated tokens held B=8 against
     B=1; a checkpoint restore with its negative control; int8_full at
     B=8; the 7B at B=2; get_all_results over the predictions; rows/s,
     the host / generate split and peak memory;
 10. [create]: the dataset-creation CLI (cli/create_dataset.py) with the
     student color backend (eval/runner.py over the Generator, a
     checkpoint of the seeded 0.5B student at full width and depth) on a
     synthetic SUNRGBD toolbox tree of 8 train and 6 validation frames at
     the four sensor sizes: 0 errors, a Color row for every frame with a
     prominent object, exact K1/K3 launch counts over the color questions,
     each question's tokens bit-equal to the Generator called directly on
     its batch, two questions' prefill logits held to the plain path, a
     raising color backend failing the CLI; then the workflow on the
     created dataset: dataset_statistics, the KD CLI's double_trouble
     phases 1 -> 2 -> 3 with the frozen bf16 7B teacher (one epoch, B=1,
     A=2, the phase hand-off), the evaluator with the phase-3 checkpoint
     at B=8 and get_all_results; each step's wall time and peak memory;
 11. [remat] (run in phase 7, before [kd8] quantizes the teacher): the
     phase-3 KD step with the student's remat off, full, dots, flash and
     full with mlp_chunk=512: loss and every gradient leaf against remat
     off, exact
     launch counts (the student's flash forwards twice under full and dots,
     once under flash), step ms, device ms and peak memory; B=2 (bench.py's
     KD default) with and without remat; xla_chunked against xla at 2+2
     layers on the plain path;
 12. [mesh]: (a) the KD CLI with --distributed --mesh 1,1,1 under a one-rank
     NCCL group (FSDP2/DTensor student, exact launch counts) held to the
     same CLI run without --distributed; (b) two processes in a gloo group
     on the card, each running K11, K5/K6, K7/K8 and K9 through the *_spmd
     wrappers on half the KD shape's rows, held to one kernel call on all
     rows, with a rank's sums left out of the all-reduce as the negative
     control;
     (c) the evaluator CLI with --distributed --mesh 1,1,1 under a
     one-rank NCCL group, bf16 (every LM parameter a DTensor at each
     generate call) and int8_full (replicated), each at B=8 on [eval]'s
     tree: the predictions CSV byte-equal to [eval]'s plain run, every
     row's tokens equal, exact launch counts;
 13. [pixtral]: the Pixtral evaluator CLI with its student backend (the
     0.5B at full width and depth) on 5 rows: answers equal to the
     student answerer called directly, exact K1/K3 launches a row, and a
     raising backend failing the CLI;
 14. [panesar]: the Panesar VGG16+LSTM baseline at the reference's widths
     (224 x 224, B=8, conv1d, 818 classes, float32, TF32 off): the card's
     logits and one Adadelta step against the CPU's at B=2 (relative
     Frobenius <= 1e-4), the steady step's time at B=8, one epoch through
     the CLI (a finite loss, the validation loss below the seeded model's),
     then its eval mode;
 15. print one JSON line of kernel results (time, plain time, the least time
     the card could take and what bounds it, and the time of one PyTorch
     call that computes the same function where there is one), then the
     result line {"ok": true, "device": {...}} last.

Phase 3 is followed by [k13]: every phase-ablation arm of K3 (K13) at the
student's and the 7B's prefill attention shapes against its plain version,
the exact arms against `full`, `full` bit-equal to K3, a negative control
(nostorem held to full's plain version), per-arm registers, SASS
instruction counts and times, and the JAX script's phase accounting.

Phase 3 also checks that two launches of the flash kernels and of K10
give bit-identical outputs, shows that K10's bounds fail a K10 fed scales
of 1, holds K1 and K3 with the lse (the output bit-equal to the one
without, the lse to the plain logsumexp) and K3 at both head dims at a
ragged S, at Sq < Skv with a kv mask and at the evaluator's B = 8 over
ragged prompts, times K1 and K3 with and without the lse, times K3 on the
causal work without a kv mask beside SDPA's `is_causal` call (the
library's speed for that work, not the same function), holds K12
bit-equal to its plain version, and logs the flash backwards' time by kernel (dq, dk/dv and K4's
reduce) from torch.profiler.  With `--parent DIR` (another checkout of the
port, e.g. the parent commit unpacked by `git archive` under build/), the
script also builds DIR's kernels and, with DIR's flash forward, flash
backward, K10, K12, K13, K11, K9 and K5-K8 launchers in place of this
checkout's, holds K1, K2, K4, K6, K8, K9, K10, K11 and K12 (at every shape
of INT8_CASES) bit-equal to DIR's output and logs whether K3, each K13 arm,
K5 and K7 are, logs K2/K4's and K5-K8's splits by kernel and each
kernel's time in turns (parent, change, change, parent), runs the [train],
[kd], [kd1], [kdfb] and [kd8] steps twice more with DIR's kernels and once
more with this checkout's (in turns; their peak memory beside each other),
and [main] and the B=8 evaluator once more beside this checkout's.

Phase 3 also holds the K11 forward and backward (with g_ce = 0 as well;
at the KD path's N = 3072 and at a ragged N = 3000, on teacher maxima tied
inside a vocab tile, across two tiles, across vocab splits and at the last
column, with LoCa and CE labels at column V - 1; two launches
bit-identical), K9 (LoCa without CE: forward, backward, two launches
bit-identical, and bit-equal to K11's LoCa part),
the temperature-KL K7 and K8 (with and without dW; two launches of K5, K6,
K7 and K8 bit-identical), the flash forward at
the teacher's D = 128, the w8a8 GEMM K12 (both activation forms, ragged K,
a decode row) and the int8-head teacher logits K10 against their plain
versions, and shows that the bounds fail a K11 backward fed tsum = 0 and
one fed g_kl = 0, a K9 backward fed tsum = 0 and one fed g = 0 for half
the rows, a K5 fed labels shifted by one column, a K7 that drops the
student's 1/T, a K8 fed a mis-normalised teacher (lse_t + 1) and one fed
g = 0 for half the rows, and K12 fed weight scales of 1 in half the columns
and one that scales every row by the first row's amax.

Needs torch with CUDA, nvcc and numpy; imports nothing of JAX or of the JAX
package: configs and synthetic batches come from the port's own host layer.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import types

import torch
import torch.nn.functional as F

# [create]'s spell check resolves its learned stage's Hugging Face model id
# from local files only; offline, a look-up of the hub would only wait.
os.environ.setdefault("HF_HUB_OFFLINE", "1")

PKG = "knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch"
REF = "knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu"
# bf16 keeps 8 significant bits: one ulp is 7.8e-3 at |x| in [1, 2) and
# 1.6e-2 in [2, 4); attention outputs here stay below ~3 in magnitude.
KERNEL_TOL = 2e-2
# Kernel path vs plain path at full depth: bf16 rounding differs in 50
# attention layers (the kernel rounds P to bf16 before PV), so the
# next-token logits are compared by direction, not elementwise.  Random
# weights give nearly flat logits, so their argmax may differ.
PATH_COSINE = 0.999
N_NEW = 32
GEN_CALLS = 3
# Every kernel output is also held by its relative Frobenius error
# ||got - plain|| / ||plain||.  The max abs bound alone cannot see a fault
# in an output whose entries are small: dq of the flash backward stays
# below ~0.06 here, and dh of the fused CE is ~4e-4 where only the softmax
# term is left.  bf16 rounding of the outputs alone gives ~2e-3.
REL_FRO_TOL = 1e-2
# The backward kernels are checked with dO scaled by 1/8, so the gradients
# they return stay below ~2 in magnitude (as the forward outputs do).
DOUT_SCALE = 0.125
# dW of the fused CE: each entry sums over all N rows, so its size is set
# by N; its max abs error is held by <= 2e-2 * max|plain|.
DW_REL_TOL = 2e-2
# 3 warm-up steps (the first allocates the AdamW state and the masters,
# the next still grow the allocator's pools), then 5 timed steps; all 8
# are counted.
WARMUP_STEPS = 3
TRAIN_STEPS = 8
ACCUM = 2
LR = 2e-5
# The float32 master of a weight of magnitude ~0.02 must move by ~lr on the
# first step (Adam's first update is lr * sign(g), plus the decay), which
# is below half a bf16 ulp there.
MASTER_PROBE = "language_model.layers.0.self_attn.q_proj.weight"
# Kernel path vs plain path at full width and 2+2 layers: bf16 rounding
# differs (the kernels round P and dS to bf16), so the loss is compared
# relatively and the gradients by direction.
LOSS_REL_TOL = 1e-2
GRAD_COSINE = 0.99
# The KD step: the CLI's learning rate; 6 steps, the mean of steps 3-6.
KD_LR = 1e-5
KD_STEPS = 6
KD_WARMUP = 2
# feature_based: a shorter run of the same shapes (steps 3-4 timed).
FB_STEPS = 4
# K11 against its plain version: max abs error <= 1e-2 x max(1, max |plain|)
# and relative Frobenius error <= 1e-2, for every output.  The forward is f32
# on both sides; the backward rounds ds to bf16 on both sides.
KD_TOL = 1e-2
# The card's published peaks (H100 SXM, dense): bf16 and int8 tensor-core
# operations and device-memory bytes per second.
PEAK_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
# time_ms's sleep before the timed calls: the H100's top SM clock (so the
# sleep errs long), and a cap for calls whose host side waits on the device.
SLEEP_CYCLES_PER_S = 1.98e9
MAX_SLEEP_S = 0.5

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli import (  # noqa: E402
    common,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.configs import (  # noqa: E402
    TrainConfig,
    kd_loss_config_for,
    llava_onevision_0_5b,
    llava_onevision_7b,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.eval.decode import (  # noqa: E402
    GenerateConfig,
    Generator,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.models import (  # noqa: E402
    qwen2,
    set_attn_impl,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.losses import (  # noqa: E402
    kd_kl_loss,
    loca_loss,
    masked_cross_entropy,
    masked_ntxent_loss,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.losses.chunked import (  # noqa: E402
    chunked_faithful_loca,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops import (  # noqa: E402
    _build,
    flash_attention as fa,
    flash_phase_ablation as k13,
    fused_ce as fc,
    fused_kl as fkl,
    fused_loca as fl,
    int8 as i8,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.train import (  # noqa: E402
    step as kd_step,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.train import (  # noqa: E402
    KDModels,
    TrainState,
    make_loss_fn,
    make_optimizer,
    make_train_step,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.utils.synthetic import (  # noqa: E402
    synthetic_kd_batch,
)

# name -> (source, the TPU kernel it replaces, its launch count).  The GQA
# flash forward runs at D = 64 (the student) and D = 128 (the teacher): one
# wrapper, counted by head dim.
KERNELS = {
    "flash_fwd_mha": ("csrc/flash_fwd_sm90.cu", "ops/flash_attention.py:600",
                      lambda: fa.flash_attention.launches),
    "flash_fwd_gqa": ("csrc/flash_gqa_sm90.cuh", "ops/flash_attention.py:1740",
                      lambda: fa.flash_attention_gqa.head_dim_launches.get(64, 0)),
    "flash_bwd_mha": ("csrc/flash_bwd_d72_sm90.cu", "ops/flash_attention.py:743",
                      lambda: fa.flash_attention_bwd.launches),
    "flash_bwd_gqa": ("csrc/flash_bwd_sm90.cu", "ops/flash_attention.py:1870",
                      lambda: fa.flash_attention_gqa_bwd.launches),
    "fused_ce_fwd": ("csrc/fused_ce.cu", "ops/fused_ce.py:238", lambda: fc.lse_gold_fwd.launches),
    "fused_ce_bwd": ("csrc/fused_ce.cu", "ops/fused_ce.py:284", lambda: fc.lse_gold_bwd.launches),
    "flash_fwd_gqa_d128": ("csrc/flash_gqa_sm90.cuh", "ops/flash_attention.py:1740",
                           lambda: fa.flash_attention_gqa.head_dim_launches.get(128, 0)),
    "fused_loca_ce_fwd": ("csrc/fused_loca_ce.cu", "ops/fused_loca.py:1103",
                          lambda: fl.loca_ce_fwd.launches),
    "fused_loca_ce_bwd": ("csrc/fused_loca_ce.cu", "ops/fused_loca.py:1168",
                          lambda: fl.loca_ce_bwd.launches),
    # K9, LoCa without CE: K11's source with its CE flag off
    "fused_loca_fwd": ("csrc/fused_loca_ce.cu", "ops/fused_loca.py:388", lambda: fl.loca_fwd.launches),
    "fused_loca_bwd": ("csrc/fused_loca_ce.cu", "ops/fused_loca.py:463", lambda: fl.loca_bwd.launches),
    "fused_kl_fwd": ("csrc/fused_kl.cu", "ops/fused_kl.py:197", lambda: fkl.kl_fwd.launches),
    # K8's dh kernel; its dW kernel is counted apart (a frozen head skips it)
    "fused_kl_bwd": ("csrc/fused_kl.cu", "ops/fused_kl.py:243", lambda: fkl.kl_bwd.launches),
    "int8_mm": ("csrc/int8_mm.cu", "ops/int8.py:165", lambda: i8.int8_matmul.launches),
    "tmat_int8": ("csrc/tmat_int8.cu", "ops/fused_loca.py:1042",
                  lambda: fl.materialize_teacher_logits_int8.launches),
    # K13, the phase-ablation arms of K3: its kernel's template parameter ARM,
    # instantiated in csrc/flash_phase_ablation_d{64,128}{a,b}.cu (the JAX
    # script's two pallas_calls: :336 for streaming_smem, :375 for every
    # other arm); no path calls them
    "flash_phase_ablation": ("csrc/flash_gqa_sm90.cuh", "scripts/flash_phase_ablation.py:375",
                             lambda: k13.phase_ablation_forward.head_dim_launches.get(64, 0)),
    "flash_phase_ablation_d128": ("csrc/flash_gqa_sm90.cuh", "scripts/flash_phase_ablation.py:375",
                                  lambda: k13.phase_ablation_forward.head_dim_launches.get(128, 0)),
}
# Every launch count a path is held to: the kernels', and K8's dW kernel.
COUNTERS = {**{name: k[2] for name, k in KERNELS.items()},
            "fused_kl_bwd_dw": lambda: fkl.kl_bwd.dw_launches}


def reset_counts() -> None:
    fa.reset_launch_counts()
    fc.reset_launch_counts()
    fl.reset_launch_counts()
    fkl.reset_launch_counts()
    i8.reset_launch_counts()
    k13.reset_launch_counts()


def read_counts() -> dict:
    return {name: count() for name, count in COUNTERS.items()}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events).  A sleep
    kernel queued first holds the device while the host enqueues the calls,
    so a call whose host side (the wrapper's checks, the launch) takes longer
    than its kernels is timed by its kernels, not by the enqueue."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda._sleep(int(min(1.5 * host_s * iters, MAX_SLEEP_S) * SLEEP_CYCLES_PER_S))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, peak: float = PEAK_FLOPS):
    """(least time in ms, what bounds it): the larger of the operations over
    their peak (bf16 unless given) and the bytes (each input read once,
    each output written once) over the memory rate."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def attended_pairs(b, sq, skv, causal, mask) -> int:
    """(query, key) pairs that attend, summed over the batch: the work this
    run's mask and causality leave (per head)."""
    valid = torch.ones(b, skv) if mask is None else mask.float().cpu()
    if not causal:
        return int(sq * valid.sum())
    cs = valid.cumsum(1)
    return int(cs[:, torch.arange(sq).clamp(max=skv - 1)].sum())


def _result(name, err, ms, plain_ms, bound_ms, library_ms=None) -> dict:
    src, line, _ = KERNELS[name]
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
    log(f"[kernel] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms[0]:.4f} ms "
        f"({bound_ms[1]}), library {lib}, max_abs_err={err:.3e}")
    replaces = line if line.startswith("scripts/") else f"{REF}/{line}"
    return dict(name=name, route="cuda", source=f"{PKG}/{src}", replaces=replaces,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms[0],
                bound_by=bound_ms[1], library_ms=library_ms)


def _sdpa_inputs(q, k, v, mask, causal, requires_grad=False):
    """BHSD copies and the boolean mask of ``scaled_dot_product_attention``
    for the same attention (the library yardstick; never called by the
    port)."""
    b, sq, _, _ = q.shape
    skv = k.shape[1]
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(requires_grad) for x in (q, k, v))
    attn_mask = None
    if mask is not None or (causal and sq != skv):
        attn_mask = fa._keep(b, sq, skv, mask, causal, q.device)[:, 0]
        causal = False
    kw = dict(attn_mask=attn_mask, is_causal=causal, enable_gqa=q.shape[2] != k.shape[2])
    return qt, kt, vt, kw


def _errors(got, want):
    """(max abs error, relative Frobenius error) of one output, in f32."""
    diff = got.float() - want.float()
    return diff.abs().max().item(), (diff.norm() / want.float().norm()).item()


def _cosine(a, b) -> float:
    """Cosine of two tensors, in float64 and without the eps floor of
    ``F.cosine_similarity``, which clamps each norm to >= 1e-8 and so scales
    the cosine of small gradients (norms ~1e-9) down towards 0."""
    a, b = a.double().flatten(), b.double().flatten()
    return ((a @ b) / (a.norm() * b.norm())).item()


def _hold(name, outs) -> float:
    """Hold each (label, got, plain, max abs bound) of a kernel: max abs error
    <= the bound and relative Frobenius error <= REL_FRO_TOL.  Returns the
    largest max abs error."""
    worst = 0.0
    for label, got, want, bound in outs:
        err, fro = _errors(got, want)
        log(f"[kernel] {name} {label}: max_abs_err={err:.3e} (tol {bound:.3e}), "
            f"rel_fro_err={fro:.3e} (tol {REL_FRO_TOL})")
        if not (err <= bound and fro <= REL_FRO_TOL):
            raise AssertionError(f"{name} {label} disagrees with its plain version: {err}, {fro}")
        worst = max(worst, err)
    return worst


def _must_fail(name, fault, outs) -> None:
    """A kernel run on faulty inputs that mimic ``fault`` must fail the
    bounds of :func:`_hold`: the check can see that fault."""
    fro = max(_errors(got, want)[1] for got, want in outs)
    log(f"[kernel] {name} with {fault}: rel_fro_err={fro:.3e}, fails the check: {fro > REL_FRO_TOL}")
    if not (fro > REL_FRO_TOL):
        raise AssertionError(f"the check of {name} cannot see {fault}: {fro}")


def load_parent(root):
    """The kernel launchers (``ops/_build.py``) of another checkout of the
    port at ``root``, e.g. the parent commit unpacked by ``git archive``:
    built from that checkout's ``csrc/`` into its own ``build/kernels/``, to
    be timed against this checkout's kernels in the same process."""
    import importlib.util
    import pathlib

    path = pathlib.Path(root).resolve() / PKG / "ops" / "_build.py"
    spec = importlib.util.spec_from_file_location("parent_build", path)
    parent = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parent)
    t0 = time.perf_counter()
    parent.load_library()
    log(f"[parent] built {parent.library_path().name} from {path.parent.parent} in {time.perf_counter() - t0:.1f} s")
    return parent


PARENT_LAUNCHERS = ("flash_fwd", "flash_bwd", "tmat_int8", "int8_quantize", "int8_gemm", "flash_phase_ablation",
                    "loca_ce_fwd", "loca_ce_bwd", "loca_fwd", "loca_bwd", "ce_fwd", "ce_bwd", "kl_fwd", "kl_bwd")
# K6's and K8's launchers: the place of the bf16 ds among their arguments
# (followed by dh_part, dh, dw and the sweep's split), and the op module
# whose ``_bwd_scratch`` sizes their scratch.  Before the two kernels moved
# onto the Hopper vocab core, their launchers took no ds and no sweep split.
_DS_AT = {"ce_bwd": (6, fc), "kl_bwd": (6, fkl)}


def _without_ds(fn, at):
    def launch(*args):
        fn(*args[:at], *args[at + 1:at + 4], *args[at + 5:])
    return launch


def _n_split(rows_per_block: int, n: int, device, blocks_per_sm: int) -> int:
    """The vocab splits of the mma.sync fused-loss kernels: about
    ``blocks_per_sm`` blocks on every SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    row_tiles = -(-n // rows_per_block)
    return max(1, -(-blocks_per_sm * sms // row_tiles))


def _old_scratch(hs, ws):
    """A backward's scratch before its kernel's redesign: no ds, and dh's
    f32 partials split as the mma.sync backward kernels split them."""
    nsplit = _n_split(32, hs.shape[0], hs.device, blocks_per_sm=2)
    return None, torch.empty(nsplit, *hs.shape, dtype=torch.float32, device=hs.device), 0


def _old_fwd_scratch(hs, ws, planes):
    """K5's and K7's forward partials before their redesign: one per vocab
    split of the mma.sync forward kernels (whose launchers read the split
    count from the scratch)."""
    nsplit = _n_split(64, hs.shape[0], hs.device, blocks_per_sm=4)
    return torch.empty(planes, nsplit, hs.shape[0], dtype=torch.float32, device=hs.device)


def _parent_launchers(parent) -> tuple:
    """The parent's launchers under this checkout's signatures, the op
    modules whose backward scratch must be the parent's (``_old_scratch``),
    and those whose forward scratch must be (``_old_fwd_scratch``: a parent
    whose sources still hold the mma.sync forwards of K5 and K7,
    ``csrc/kdss_vocab.cuh``), so that the parent's kernels run on their own
    grids and a step with them holds the parent's memory."""
    import inspect
    import pathlib

    launchers, old_scratch = {}, set()
    for name in PARENT_LAUNCHERS:
        fn = getattr(parent, name)
        if name in _DS_AT and "ds" not in inspect.signature(fn).parameters:
            at, module = _DS_AT[name]
            fn = _without_ds(fn, at)
            old_scratch.add(module)
        launchers[name] = fn
    mma_forwards = (pathlib.Path(parent.CSRC_DIR) / "kdss_vocab.cuh").exists()
    return launchers, old_scratch, {fc, fkl} if mma_forwards else set()


@contextlib.contextmanager
def parent_kernels(parent):
    """Route the flash forward (K1/K3), the flash backward (K2/K4), K10, K12
    (its quantize pass and GEMM), K13, K11, K9 and K5-K8 through the
    parent's launchers (:func:`_parent_launchers`).  The wrappers, their
    checks and their counters stay this checkout's."""
    saved = {name: getattr(_build, name) for name in PARENT_LAUNCHERS}
    launchers, old_scratch, old_fwd = _parent_launchers(parent)
    saved_scratch = {m: m._bwd_scratch for m in old_scratch}
    saved_fwd = {m: m._fwd_scratch for m in old_fwd}
    for name, fn in launchers.items():
        setattr(_build, name, fn)
    for m in old_scratch:
        m._bwd_scratch = _old_scratch
    for m in old_fwd:
        m._fwd_scratch = _old_fwd_scratch
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(_build, name, fn)
        for m, fn in saved_scratch.items():
            m._bwd_scratch = fn
        for m, fn in saved_fwd.items():
            m._fwd_scratch = fn


def steps_in_turns(parent, run, tag: str, first: dict) -> dict:
    """A path's step times in turns: this checkout's run ``first``, then
    ``run`` with the parent's kernels twice and with this checkout's again.
    Returns the parent's runs (their mean step ms, the first one's losses
    and peak memory)."""
    with parent_kernels(parent):
        theirs = [run(f"{tag}-parent"), run(f"{tag}-parent")]
    again = run(f"{tag}-again")
    ms = [first["step_ms"], theirs[0]["step_ms"], theirs[1]["step_ms"], again["step_ms"]]
    log(f"[{tag}] step ms, change / parent / parent / change: " + " / ".join(f"{t:.1f}" for t in ms))
    return dict(step_ms=(ms[1] + ms[2]) / 2, change_ms=(ms[0] + ms[3]) / 2, losses=theirs[0]["losses"],
                peak=theirs[0]["peak"])


def kernel_split(fn, iters: int = 5) -> dict:
    """Device ms per call of each kernel that ``fn`` launches
    (torch.profiler; kernels only, not annotation ranges)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        name = e.name.removeprefix("void ")
        name = (name[:name.rfind("(")] if name.endswith(")") else name)[:60]  # without the argument list
        out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / iters
    return out


def log_in_turns(label: str, parent_fn, change_fn, iters: int) -> None:
    """Log the mean device ms of the parent's and this checkout's version
    of one call, timed in turns: parent, change, change, parent."""
    ms = [time_ms(fn, iters=iters) for fn in (parent_fn, change_fn, change_fn, parent_fn)]
    log(f"[kernel] {label} parent / change / change / parent ms: " + " / ".join(f"{t:.4f}" for t in ms))


def _same_as_parent(parent, name, kernel, got, must) -> None:
    """Log whether the parent's kernel gives ``got``'s bits on the same
    inputs; raise if it does not and ``must``."""
    with parent_kernels(parent):
        theirs = kernel()
    torch.cuda.synchronize()
    got, theirs = (got,) if torch.is_tensor(got) else got, (theirs,) if torch.is_tensor(theirs) else theirs
    same = all(torch.equal(a, b) for a, b in zip(got, theirs))
    log(f"[kernel] {name}: bit-equal to the parent's output: {same}; max abs difference "
        + ", ".join(f"{_errors(a, b)[0]:.3e}" for a, b in zip(got, theirs)))
    if must and not same:
        raise AssertionError(f"{name} is no longer bit-equal to the parent's kernel")


def _theirs(parent, fn):
    def run():
        with parent_kernels(parent):
            return fn()
    return run


LSE_TOL = 1e-3


def _hold_lse(name, got, out_l, lse_l, want_lse) -> None:
    """A forward run with the lse: its output bit-equal to the run without
    it, its lse within LSE_TOL of the plain logsumexp where that is finite
    and -inf where it is (rows with no valid key)."""
    live = torch.isfinite(want_lse)
    err = (lse_l[live] - want_lse[live]).abs().max().item() if bool(live.any()) else 0.0
    same = torch.equal(out_l, got)
    log(f"[kernel] {name} with the lse: output bit-equal to the one without: {same}; lse max_abs_err={err:.3e} "
        f"(tol {LSE_TOL}), -inf where the plain lse is: {torch.equal(torch.isfinite(lse_l), live)}")
    if not (same and err <= LSE_TOL and torch.equal(torch.isfinite(lse_l), live)):
        raise AssertionError(f"{name}'s lse disagrees with its plain version")


# K3 beyond the main paths' two shapes: (label, b, sq, skv, q heads, kv
# heads, valid keys per batch row or None), causal, at d = 64 and 128.
K3_CASES = (
    ("ragged S = 200", 2, 200, 200, 14, 2, None),
    ("Sq < Skv, a kv mask", 1, 100, 230, 14, 2, [150]),
    ("the evaluator's B = 8 over ragged prompts", 8, 700, 732, 14, 2, [732, 700, 640, 612, 540, 451, 380, 300]),
)


def k3_cases(dev, g) -> None:
    """K3 (``flash_attention_gqa``) at K3_CASES at both head dims: output
    within KERNEL_TOL of the plain version, the lse held by
    :func:`_hold_lse`, two launches bit-identical."""
    for d, scale_heads in ((64, 1), (128, 2)):
        for label, b, sq, skv, hq, hkv, lengths in K3_CASES:
            hq, hkv = hq * scale_heads, hkv * scale_heads
            q, k, v = (torch.randn(b, s, h, d, generator=g, device=dev).to(torch.bfloat16)
                       for s, h in ((sq, hq), (skv, hkv), (skv, hkv)))
            mask = None
            if lengths is not None:
                mask = torch.arange(skv, device=dev)[None, :] < torch.tensor(lengths, device=dev)[:, None]
            with torch.no_grad():
                got, again = (fa.flash_attention_gqa(q, k, v, mask=mask, causal=True) for _ in range(2))
            out_l, lse_l = torch.empty_like(q), torch.empty(b, hq, sq, device=dev)
            _build.flash_fwd(q, k, v, None if mask is None else mask.view(torch.uint8), out_l, lse_l, True, d**-0.5)
            torch.cuda.synchronize()
            want, want_lse = fa.flash_attention_ref(q, k, v, mask, True, return_lse=True)
            name = f"flash_fwd_gqa d={d}, {label}"
            _hold(name, [("out", got, want, KERNEL_TOL)])
            _hold_lse(name, got, out_l, lse_l, want_lse)
            log(f"[kernel] {name}: two launches bit-identical: {torch.equal(got, again)}")
            if not torch.equal(got, again):
                raise AssertionError(f"{name} is not deterministic")


def _causal_yardstick(name, q, k, v) -> None:
    """Log K3's time on the causal work of its first Sq = Skv keys without a
    kv mask beside SDPA's ``is_causal`` call on the same work: the library's
    speed for that work (its flash backend), not the same function as the
    masked call (the masked keys and the padded query rows differ)."""
    s = q.shape[1]
    kc, vc = k[:, :s].contiguous(), v[:, :s].contiguous()
    with torch.no_grad():
        ms = time_ms(lambda: fa.flash_attention_gqa(q, kc, vc, causal=True), iters=20)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, kc, vc))
    lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True), iters=20)
    log(f"[kernel] {name} on the causal work without a kv mask (Sq = Skv = {s}): kernel {ms:.4f} ms, SDPA "
        f"is_causal {lib:.4f} ms (the library's speed for that work, not the same function as the masked "
        f"call: the masked keys and padded query rows differ)")
    del qt, kt, vt, kc, vc


def flash_kernel_phase(dev, g, parent=None) -> list:
    """K1-K4 against their plain versions at the main paths' shapes, with
    the forwards' times with and without the lse, K3's time beside SDPA's
    causal call without a mask, and K2/K4's split by kernel; with ``parent``,
    each against the parent's kernel in turns (K1, K2 and K4, unchanged,
    held bit-equal to it; K3, redesigned, compared and logged)."""

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(torch.bfloat16)

    def kv_mask(b, skv, n_valid):
        if n_valid is None:
            return None
        mask = torch.zeros(b, skv, dtype=torch.bool, device=dev)
        mask[:, :n_valid] = True
        return mask

    results = []
    fwd_cases = [
        # SigLIP: 10 tiles x 729 tokens, 16 heads, d=72, non-causal, no mask
        dict(name="flash_fwd_mha", entry=fa.flash_attention,
             q=(10, 729, 16, 72), kv=(10, 729, 16, 72), causal=False, n_valid=None),
        # Qwen2 prefill: 3072 queries over the fresh 3104-slot cache, 14q/2kv,
        # d=64, causal, kv mask of the 2936-token SUNRGBD prompt
        dict(name="flash_fwd_gqa", entry=fa.flash_attention_gqa,
             q=(1, 3072, 14, 64), kv=(1, 3104, 2, 64), causal=True, n_valid=2936),
        # the 7B teacher's prefill in the KD step: 28q/4kv, d=128, causal,
        # the kv mask of the same prompt, no lse (the teacher is frozen)
        dict(name="flash_fwd_gqa_d128", entry=fa.flash_attention_gqa,
             q=(1, 3072, 28, 128), kv=(1, 3072, 4, 128), causal=True, n_valid=2936),
    ]
    for c in fwd_cases:
        q, k, v = randn(*c["q"]), randn(*c["kv"]), randn(*c["kv"])
        mask = kv_mask(c["kv"][0], c["kv"][1], c["n_valid"])
        b, sq, hq, d = c["q"]

        def kernel():
            return c["entry"](q, k, v, mask=mask, causal=c["causal"])

        def plain():
            return fa.flash_attention_ref(q, k, v, mask, c["causal"])

        got = kernel()
        torch.cuda.synchronize()
        want, want_lse = fa.flash_attention_ref(q, k, v, mask, c["causal"], return_lse=True)
        err = _hold(c["name"], [("out", got, want, KERNEL_TOL)])
        again = kernel()
        torch.cuda.synchronize()
        log(f"[kernel] {c['name']}: two launches bit-identical: {torch.equal(got, again)}")
        if not torch.equal(got, again):
            raise AssertionError(f"{c['name']} is not deterministic")
        pairs = attended_pairs(b, sq, c["kv"][1], c["causal"], mask)
        least = bound(4 * pairs * hq * d, nbytes(q, k, v, got, mask))
        mask_u8 = None if mask is None else mask.view(torch.uint8)
        out_l, lse_l = torch.empty_like(q), torch.empty(b, hq, sq, device=dev)

        def with_lse():  # the launcher, as the autograd forward calls it (not counted)
            _build.flash_fwd(q, k, v, mask_u8, out_l, lse_l, c["causal"], d**-0.5)

        with_lse()
        torch.cuda.synchronize()
        _hold_lse(c["name"], got, out_l, lse_l, want_lse)
        del want, want_lse
        log(f"[kernel] {c['name']} with the lse: {time_ms(with_lse, iters=20):.4f} ms")
        if c["causal"]:
            _causal_yardstick(c["name"], q, k, v)
        if parent is not None:
            _same_as_parent(parent, c["name"], kernel, got, must=c["name"] == "flash_fwd_mha")
            log_in_turns(c["name"], _theirs(parent, kernel), kernel, iters=20)
            log_in_turns(c["name"] + " with the lse", _theirs(parent, with_lse), with_lse, iters=20)
        qt, kt, vt, kw = _sdpa_inputs(q, k, v, mask, c["causal"])
        library = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw), iters=20)
        del got, again, qt, kt, vt, out_l, lse_l
        results.append(_result(c["name"], err, time_ms(kernel, iters=20), time_ms(plain, iters=5, warmup=1),
                               least, library))
    k3_cases(dev, g)

    bwd_cases = [
        # the training shapes: SigLIP as above; Qwen2 over its own 3072 keys
        dict(name="flash_bwd_mha", entry=fa.flash_attention_bwd,
             q=(10, 729, 16, 72), kv=(10, 729, 16, 72), causal=False, n_valid=None),
        dict(name="flash_bwd_gqa", entry=fa.flash_attention_gqa_bwd,
             q=(1, 3072, 14, 64), kv=(1, 3072, 2, 64), causal=True, n_valid=2936),
    ]
    for c in bwd_cases:
        q, k, v = randn(*c["q"]), randn(*c["kv"]), randn(*c["kv"])
        dout = randn(*c["q"], std=DOUT_SCALE)
        mask = kv_mask(c["kv"][0], c["kv"][1], c["n_valid"])
        out, lse = fa.flash_attention_ref(q, k, v, mask, c["causal"], return_lse=True)
        delta = fa.attention_delta(out, dout)
        lse_n, delta_n = fa.neutralize_dead_rows(lse, delta)
        scale = c["q"][3] ** -0.5

        def kernel():
            return c["entry"](q, k, v, dout, lse, delta, mask=mask, causal=c["causal"])

        def plain():
            return fa.flash_attention_bwd_ref(q, k, v, mask, c["causal"], scale, lse_n, delta_n, dout)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = _hold(c["name"], [(lbl, a, b, KERNEL_TOL) for lbl, a, b in zip(("dq", "dk", "dv"), got, want)])
        again = kernel()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        log(f"[kernel] {c['name']}: two launches bit-identical: {same}")
        if not same:
            raise AssertionError(f"{c['name']} is not deterministic")
        # a backward that drops delta from dS = P * (dP - delta)
        no_delta = c["entry"](q, k, v, dout, lse, torch.zeros_like(delta), mask=mask, causal=c["causal"])
        _must_fail(c["name"], "delta = 0", list(zip(no_delta[:2], want[:2])))
        del again, no_delta
        split = kernel_split(kernel)
        log(f"[kernel] {c['name']} split (torch.profiler, ms a call): "
            + ", ".join(f"{n} {ms:.4f}" for n, ms in split.items()))
        if parent is not None:
            _same_as_parent(parent, c["name"], kernel, got, must=True)
            with parent_kernels(parent):
                parent_split = kernel_split(kernel)
            log(f"[kernel] {c['name']} parent split (ms a call): "
                + ", ".join(f"{n} {ms:.4f}" for n, ms in parent_split.items()))
            log_in_turns(c["name"], _theirs(parent, kernel), kernel, iters=10)
        b, sq, hq, d = c["q"]
        pairs = attended_pairs(b, sq, c["kv"][1], c["causal"], mask)
        least = bound(10 * pairs * hq * d, nbytes(q, k, v, dout, lse, delta, *got, mask))
        del got, want
        # the library yardstick: SDPA's autograd backward at the same shapes
        qt, kt, vt, kw = _sdpa_inputs(q, k, v, mask, c["causal"], requires_grad=True)
        out_t = F.scaled_dot_product_attention(qt, kt, vt, **kw)
        dout_t = dout.transpose(1, 2).contiguous()
        library = time_ms(lambda: torch.autograd.grad(out_t, (qt, kt, vt), dout_t, retain_graph=True),
                          iters=10)
        del qt, kt, vt, out_t, dout_t
        results.append(_result(c["name"], err, time_ms(kernel, iters=10), time_ms(plain, iters=3, warmup=1),
                               least, library))
    return results


def kernel_phase(dev, parent=None) -> list:
    """Each kernel against its plain version at the main paths' shapes; with
    ``parent``, each also against the parent's kernel in turns."""
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(torch.bfloat16)

    results = flash_kernel_phase(dev, g, parent)
    # Fused CE over the tied head: B*S = 3072 rows, the 151936 x 896 embedding.
    cfg = llava_onevision_0_5b()
    n, d, vocab = 3072, cfg.text.hidden_size, cfg.text.vocab_size
    h, w = randn(n, d), randn(vocab, d, std=0.02)
    labels = torch.randint(0, vocab, (n,), generator=g, device=dev, dtype=torch.int32)
    labels[1] = vocab - 1
    results.append(ce_fwd_kernel_phase(h, w, labels, parent))
    lse, _ = fc.lse_gold_ref(h, w, labels)
    results.append(ce_bwd_kernel_phase(h, w, labels, lse, parent))
    del h, w
    torch.cuda.empty_cache()
    results += loca_kernel_phase(dev, g, parent)
    results += kl_kernel_phase(dev, g, parent)
    results += int8_kernel_phase(dev, g, parent)
    return results


def ce_fwd_kernel_phase(h, w, labels, parent=None) -> dict:
    """K5 (the fused CE forward on the Hopper vocab core) against its plain
    version on ``kernel_phase``'s inputs (a label at column V - 1), a
    negative control (labels shifted by one column: the gold logit of
    another column must fail the bounds), two launches bit-identical, its
    split by kernel and its time; with ``parent``, the parent's K5 in turns
    (bits logged, not held: the kernel is redesigned)."""
    n, d, vocab = h.shape[0], h.shape[1], w.shape[0]

    def fwd():
        return fc.lse_gold_fwd(h, w, labels)

    got = fwd()
    torch.cuda.synchronize()
    want = fc.lse_gold_ref(h, w, labels)
    err = _hold("fused_ce_fwd", [("lse", got[0], want[0], KERNEL_TOL), ("gold", got[1], want[1], KERNEL_TOL)])
    _must_fail("fused_ce_fwd", "labels shifted by one column",
               list(zip(fc.lse_gold_fwd(h, w, (labels + 1) % vocab), want)))
    _bit_identical("fused_ce_fwd", fwd)
    _log_split("fused_ce_fwd", fwd, parent)
    if parent is not None:
        _same_as_parent(parent, "fused_ce_fwd", fwd, got, must=False)
        log_in_turns("fused_ce_fwd", _theirs(parent, fwd), fwd, iters=5)
    # no single PyTorch call computes (lse, gold) over a streamed head
    return _result("fused_ce_fwd", err, time_ms(fwd, iters=5),
                   time_ms(lambda: fc.lse_gold_ref(h, w, labels), iters=3, warmup=1),
                   bound(2 * n * d * vocab, nbytes(h, w, labels, *got)))


def ce_bwd_kernel_phase(h, w, labels, lse, parent=None) -> dict:
    """K6 (the fused CE backward on the Hopper vocab core) against its plain
    version on ``kernel_phase``'s inputs, with unit cotangents (the summed
    NLL): with g_gold = -1 the gold term -w_label dominates dh and dW; with
    g_gold = 0 they are the softmax term sum_v p_v w_v alone, which a kernel
    must get right on its own, and a backward without that term (g_lse = 0)
    must fail the bounds.  Two launches bit-identical; its time, and with
    ``parent`` the parent's K6 in turns (held bit-equal to it) and both
    splits by kernel."""
    n, d, vocab = h.shape[0], h.shape[1], w.shape[0]
    ones = torch.ones(n, device=h.device)
    err = 0.0
    for case, g_gold in (("g_gold=-1", -ones), ("g_gold=0", torch.zeros_like(ones))):
        dh, dw = fc.lse_gold_bwd(h, w, labels, lse, ones, g_gold)
        torch.cuda.synchronize()
        want_dh, want_dw = fc.lse_gold_bwd_ref(h, w, labels, lse, ones, g_gold)
        err = max(err, _hold(f"fused_ce_bwd {case}", [
            ("dh", dh, want_dh, KERNEL_TOL),
            ("dW", dw, want_dw, DW_REL_TOL * want_dw.float().abs().max().item())]))
        del dh, dw
    # a backward without the g_lse * p term: here dh and dW would be zero
    no_softmax = fc.lse_gold_bwd(h, w, labels, lse, torch.zeros_like(ones), g_gold)
    _must_fail("fused_ce_bwd g_gold=0", "g_lse = 0", list(zip(no_softmax, (want_dh, want_dw))))
    del no_softmax, want_dh, want_dw
    g_gold = -ones

    def bwd():
        return fc.lse_gold_bwd(h, w, labels, lse, ones, g_gold)

    _bit_identical("fused_ce_bwd", bwd)
    _log_split("fused_ce_bwd", bwd, parent)
    if parent is not None:
        _same_as_parent(parent, "fused_ce_bwd", bwd, bwd(), must=True)
        log_in_turns("fused_ce_bwd", _theirs(parent, bwd), bwd, iters=3)
    return _result("fused_ce_bwd", err, time_ms(bwd, iters=3),
                   time_ms(lambda: fc.lse_gold_bwd_ref(h, w, labels, lse, ones, g_gold), iters=2, warmup=1),
                   bound(6 * n * d * vocab, 2 * nbytes(h, w) + nbytes(labels, lse, ones, g_gold)))


def _log_split(name, fn, parent=None) -> None:
    """Log ``fn``'s device ms a call by kernel, and with ``parent`` the
    parent's split of the same call."""
    log(f"[kernel] {name} by kernel (ms a call): "
        + ", ".join(f"{k} {t:.4f}" for k, t in kernel_split(fn, iters=2).items()))
    if parent is not None:
        with parent_kernels(parent):
            split = kernel_split(fn, iters=2)
        log(f"[kernel] {name} parent split (ms a call): " + ", ".join(f"{k} {t:.4f}" for k, t in split.items()))


# [k13]: (entry name, q heads, kv heads, head dim) at S = 3072: K3's shapes
# in the student's and the 7B's Qwen2.
K13_CASES = (("flash_phase_ablation", 14, 2, 64), ("flash_phase_ablation_d128", 28, 4, 128))
K13_SEQ = 3072


def k13_build_stats() -> dict:
    """(registers, SASS instructions) of each K13 arm's kernel in the built
    library, by (head dim, arm): registers from the build log's ptxas lines,
    instructions from ``cuobjdump -sass``.  An arm whose count falls by more
    than its dropped phase lets the compiler delete more than that."""
    import os
    import re

    from torch.utils.cpp_extension import CUDA_HOME

    def arm_of(line):
        m = re.search(r"kdss_gqa90\d*fwd_kernelILi(\d+)ELb1ELb0ELi(\d+)E", line)
        return (int(m[1]), k13.ARMS[int(m[2])]) if m else None

    regs, cur = {}, None
    for line in _build.library_path().with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            cur = arm_of(line)
        elif cur and "Used" in line:
            regs[cur] = int(re.search(r"Used (\d+) registers", line)[1])
    text = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", str(_build.library_path())],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    sass, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = arm_of(line)
            if cur:
                sass[cur] = 0
        elif cur and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", line):
            sass[cur] += 1
    return {key: (regs.get(key), sass[key]) for key in sass}


def k13_phase(dev, parent=None) -> list:
    """[k13]: every phase-ablation arm at each of K13_CASES on standard-normal
    bf16 inputs, causal, no mask: each arm against its plain version at the
    kernel's tiling (max abs error <= 2e-2 x max(1, max |plain|) and relative
    Frobenius error <= REL_FRO_TOL where both are finite; noexp and mxu
    also non-finite at the same positions, every other arm finite), the
    exact arms against ``full``, ``full`` bit-equal to K3's own output
    (``flash_attention_gqa``, no mask), a negative control (nostorem's
    output, which keeps no running max and so attends to the last visited
    tile alone, against full's plain version must fail the bounds), then each
    arm's time and the script's phase accounting; with ``parent``, each arm
    against the parent's kernel in turns (bit-equality logged, not held: the
    kernel is redesigned)."""
    g = torch.Generator(device=dev).manual_seed(13)
    results = []
    stats = k13_build_stats()
    for name, hq, hkv, d in K13_CASES:
        log(f"[k13] d={d} registers / SASS instructions per arm (ptxas, cuobjdump): "
            + ", ".join(f"{a} {'/'.join(map(str, stats.get((d, a), ('missing',))))}" for a in k13.ARMS))
        if any((d, a) not in stats for a in k13.ARMS):
            raise AssertionError(f"K13 arms missing from the library's SASS at d={d}: {stats}")
        q, k, v = (torch.randn(1, K13_SEQ, h, d, generator=g, device=dev).to(torch.bfloat16)
                   for h in (hq, hkv, hkv))
        with torch.no_grad():
            k3 = fa.flash_attention_gqa(q, k, v, causal=True)
        full = k13.phase_ablation_forward(q, k, v, "full")
        torch.cuda.synchronize()
        same = torch.equal(full, k3)
        log(f"[k13] d={d}, {hq}q/{hkv}kv, S={K13_SEQ}: full bit-equal to K3 (flash_attention_gqa): {same}")
        if not same:
            raise AssertionError(f"K13's full arm is not K3 at d={d}")
        worst = 0.0
        for arm in k13.ARMS:
            got = k13.phase_ablation_forward(q, k, v, arm)
            torch.cuda.synchronize()
            want = k13.phase_ablation_ref(q, k, v, arm)
            check = k13.check_arm(got, want, arm)
            nonfinite = int((~torch.isfinite(got)).sum())
            if check is None:
                raise AssertionError(f"K13 {arm} d={d}: non-finite at other positions than its plain version")
            err, tol, fro = check
            line = (f"[k13] d={d} {arm}: max_abs_err={err:.3e} (tol {tol:.3e}), rel_fro_err={fro:.3e} "
                    f"(tol {REL_FRO_TOL}), non-finite {nonfinite} of {got.numel()}")
            if arm in k13.EXACT_ARMS:
                vs_full = (got.float() - full.float()).abs().max().item()
                line += f"; vs full max abs {vs_full:.3e} (tol {KERNEL_TOL})"
                if not vs_full <= KERNEL_TOL:
                    raise AssertionError(f"K13 {arm} d={d} diverged from full: {vs_full}")
            log(line)
            if not (err <= tol and fro <= REL_FRO_TOL):
                raise AssertionError(f"K13 {arm} d={d} disagrees with its plain version: {check}")
            worst = max(worst, err)
            if arm == "nostorem":  # attention over the last tile alone: held to full, it must fail
                _must_fail(f"k13 d={d} nostorem", "full's plain version as its reference",
                           [(got, fa.flash_attention_ref(q, k, v, None, causal=True))])
            del got, want
        ms = {arm: k13.time_arm(q, k, v, arm, iters=20) for arm in k13.ARMS}
        log(f"[k13] d={d} ms/pass: " + ", ".join(f"{a} {t:.4f}" for a, t in ms.items()))
        if parent is not None:
            for arm in k13.ARMS:
                def run(arm=arm):
                    return k13.phase_ablation_forward(q, k, v, arm)

                _same_as_parent(parent, f"k13 d={d} {arm}", run, run(), must=False)
                log_in_turns(f"k13 d={d} {arm}", _theirs(parent, run), run, iters=10)
        # streaming_smem's pass includes the wrapper's shift (PyTorch ops over
        # q and k, as the script's jitted call computes it); its kernel alone:
        shift, out = k13.streaming_shift(q, k, d**-0.5), torch.empty_like(q)
        alone = time_ms(lambda: _build.flash_phase_ablation(q, k, v, out, shift, k13.ARMS.index("streaming_smem"),
                                                            d**-0.5), iters=20)
        log(f"[k13] d={d} streaming_smem kernel alone (shift precomputed) {alone:.4f} ms; the wrapper's shift "
            f"{ms['streaming_smem'] - alone:.4f} ms")
        for line in k13.accounting(ms, K13_SEQ, hq, d):
            log(f"[k13] d={d} {line}")
        plain_ms = time_ms(lambda: k13.phase_ablation_ref(q, k, v, "full"), iters=3, warmup=1)
        least = bound(4 * attended_pairs(1, K13_SEQ, K13_SEQ, True, None) * hq * d, nbytes(q, k, v, full))
        qt, kt, vt, kw = _sdpa_inputs(q, k, v, None, True)
        library = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw), iters=10)
        del qt, kt, vt, q, k, v, full, k3
        results.append(_result(name, worst, ms["full"], plain_ms, least, library))
    torch.cuda.empty_cache()
    return results


# K11 / K9 beyond the main shape: N a multiple of neither the sweep's 64-row
# block nor the products' 128-row tile (V = 151936 is no multiple of 256).
LOCA_RAGGED_N = 3000


def _loca_inputs(dev, g, n, vocab, d):
    """K11's operands at ``n`` rows: h, the head, an f32 teacher-logit matrix
    whose rows are peaked (std 3), with the teacher maximum duplicated in a
    few rows inside one vocab tile (columns 5 and 7), across two tiles
    (120 and 130), across vocab splits (11 and V - 3) and at the last column
    (0 and V - 1); LoCa labels at a tied maximum and at column V - 1, a CE
    label at V - 1, and ignored LoCa and CE labels in others."""
    hs = torch.randn(n, d, generator=g, device=dev).to(torch.bfloat16)
    ws = (torch.randn(vocab, d, generator=g, device=dev) * 0.05).to(torch.bfloat16)
    tmat = torch.randn(n, vocab, generator=g, device=dev) * 3.0
    top = tmat.max(dim=1).values + 2.0
    tmat[0:8, 5] = tmat[0:8, 7] = top[0:8]
    tmat[8:16, 11] = tmat[8:16, vocab - 3] = top[8:16]
    tmat[16:24, 120] = tmat[16:24, 130] = top[16:24]
    tmat[24:28, 0] = tmat[24:28, vocab - 1] = top[24:28]
    lab = torch.randint(0, vocab, (n,), generator=g, device=dev, dtype=torch.int32)
    lab_ce = torch.randint(0, vocab, (n,), generator=g, device=dev, dtype=torch.int32)
    lab[0], lab[8], lab[16], lab[24] = 5, 11, 130, vocab - 1  # labels at a tied maximum
    lab[30] = lab_ce[31] = vocab - 1
    lab[100:300] = -1
    lab_ce[-150:] = -1
    return hs, ws, tmat, lab, lab_ce


def _kd_bound(want):
    return KD_TOL * max(1.0, want.float().abs().max().item())


def _bit_identical(name, run) -> None:
    """Two launches of ``run`` give the same bits."""
    a, b = run(), run()
    torch.cuda.synchronize()
    a, b = (a,) if torch.is_tensor(a) else a, (b,) if torch.is_tensor(b) else b
    same = all(torch.equal(x, y) for x, y in zip(a, b) if x is not None)
    log(f"[kernel] {name}: two launches bit-identical: {same}")
    if not same:
        raise AssertionError(f"{name} is not deterministic")


def loca_kernel_phase(dev, g, parent=None) -> list:
    """K11 forward and backward, and K9, against their plain versions at the
    KD path's shapes (N = 3072 rows, the 896-wide student head of 151936
    rows) and at the ragged N = LOCA_RAGGED_N on ``_loca_inputs``: every
    output within KD_TOL, the negative controls failing, two launches
    bit-identical, K9 bit-equal to K11's LoCa part; then the times at the
    main shape and, with ``parent``, the parent's kernels in turns, their
    outputs held bit-equal to the parent's."""
    cfg = llava_onevision_0_5b()
    d, vocab = cfg.text.hidden_size, cfg.text.vocab_size
    lc = kd_loss_config_for("double_trouble")
    kw = dict(inv_t=1.0 / lc.temperature, eps=1e-8)
    for n in (LOCA_RAGGED_N, 3072):
        tag = "" if n == 3072 else f" N={n}"
        hs, ws, tmat, lab, lab_ce = _loca_inputs(dev, g, n, vocab, d)

        def fwd():
            return fl.loca_ce_fwd(hs, ws, tmat, lab, lab_ce, alpha=lc.loca_alpha, **kw)

        def fwd_plain():
            return fl.loca_ce_rows_ref(hs, ws, tmat, lab, lab_ce, alpha=lc.loca_alpha, **kw)

        got = fwd()
        torch.cuda.synchronize()
        want = fwd_plain()
        outs = [("kl", got[0], want[0]), ("ce", got[1], want[1])]
        outs += [(name, a, b) for name, a, b in zip(fl.ROW_STATS, got[2], want[2])]
        fwd_err = _hold("fused_loca_ce_fwd" + tag, [(lbl, a, b, _kd_bound(b)) for lbl, a, b in outs])
        _bit_identical("fused_loca_ce_fwd" + tag, fwd)
        stats = want[2]
        del got, want

        # Unit cotangents; with g_ce = 0, dh and dW are the LoCa term alone.
        ones, zeros = torch.ones(n, device=dev), torch.zeros(n, device=dev)
        bwd_err = 0.0
        for case, g_ce in (("g_ce=1", ones), ("g_ce=0", zeros)):
            dh, dw = fl.loca_ce_bwd(hs, ws, tmat, lab, lab_ce, stats, ones, g_ce, **kw)
            torch.cuda.synchronize()
            want_dh, want_dw = fl.loca_ce_rows_bwd_ref(hs, ws, tmat, lab, lab_ce, stats, ones, g_ce, **kw)
            bwd_err = max(bwd_err, _hold(f"fused_loca_ce_bwd{tag} {case}", [
                ("dh", dh, want_dh, _kd_bound(want_dh)), ("dW", dw, want_dw, _kd_bound(want_dw))]))
            del dh, dw
        # a backward that loses the p_sT * tsum term (LoCa alone, g_ce = 0) ...
        no_tsum = stats.clone()
        no_tsum[fl.ROW_STATS.index("tsum")] = 0.0
        faulty = fl.loca_ce_bwd(hs, ws, tmat, lab, lab_ce, no_tsum, ones, zeros, **kw)
        _must_fail(f"fused_loca_ce_bwd{tag} g_ce=0", "tsum = 0", list(zip(faulty, (want_dh, want_dw))))
        # ... and one that loses the whole KL term, against the true g_kl
        want = fl.loca_ce_rows_bwd_ref(hs, ws, tmat, lab, lab_ce, stats, ones, ones, **kw)
        faulty = fl.loca_ce_bwd(hs, ws, tmat, lab, lab_ce, stats, zeros, ones, **kw)
        _must_fail(f"fused_loca_ce_bwd{tag} g_ce=1", "g_kl = 0", list(zip(faulty, want)))
        del faulty, want, want_dh, want_dw, no_tsum

        def bwd():
            return fl.loca_ce_bwd(hs, ws, tmat, lab, lab_ce, stats, ones, ones, **kw)

        def bwd_plain():
            return fl.loca_ce_rows_bwd_ref(hs, ws, tmat, lab, lab_ce, stats, ones, ones, **kw)

        _bit_identical("fused_loca_ce_bwd" + tag, bwd)
        alone = loca_alone_kernel_phase(hs, ws, tmat, lab, lab_ce, stats, lc.loca_alpha, kw, tag,
                                        parent if n == 3072 else None)
        if n != 3072:
            del hs, ws, tmat, stats
            torch.cuda.empty_cache()
            continue
        _log_split("fused_loca_ce_bwd", bwd)
        _log_split("fused_loca_ce_fwd", fwd)
        if parent is not None:
            _same_as_parent(parent, "fused_loca_ce_fwd", fwd, fwd(), must=True)
            _same_as_parent(parent, "fused_loca_ce_bwd", bwd, bwd(), must=True)
            log_in_turns("fused_loca_ce_fwd", _theirs(parent, fwd), fwd, iters=5)
            log_in_turns("fused_loca_ce_bwd", _theirs(parent, bwd), bwd, iters=3)
        got = fwd()
        # no single PyTorch call computes the LoCa row statistics or their
        # gradient over a streamed head
        results = [_result("fused_loca_ce_fwd", fwd_err, time_ms(fwd, iters=5),
                           time_ms(fwd_plain, iters=2, warmup=1),
                           bound(2 * n * d * vocab, nbytes(hs, ws, tmat, lab, lab_ce, *got))),
                   _result("fused_loca_ce_bwd", bwd_err, time_ms(bwd, iters=3),
                           time_ms(bwd_plain, iters=2, warmup=1),
                           bound(6 * n * d * vocab,
                                 2 * nbytes(hs, ws) + nbytes(tmat, lab, lab_ce, stats, ones, ones)))]
        del got, stats, hs, ws, tmat
        torch.cuda.empty_cache()
    return results + alone


def loca_alone_kernel_phase(hs, ws, tmat, lab, lab_ce, stats, alpha, kw, tag="", parent=None) -> list:
    """K9 (LoCa without CE) forward and backward against their plain
    versions on ``loca_kernel_phase``'s inputs (``stats``: K11's plain row
    statistics there), two negative controls (tsum = 0, and g = 0 in half
    the rows), two launches bit-identical, and K9 bit-equal to K11's LoCa
    part on the same inputs: its KL rows and statistics to K11's, its dh
    and dW to K11's backward with g_ce = 0.  Its times at the main shape
    (``tag`` empty), with ``parent`` in turns with the parent's kernels,
    its outputs held bit-equal to the parent's."""
    n, d, vocab = hs.shape[0], hs.shape[1], ws.shape[0]

    def fwd():
        return fl.loca_fwd(hs, ws, tmat, lab, alpha=alpha, **kw)

    def fwd_plain():
        return fl.loca_rows_ref(hs, ws, tmat, lab, alpha=alpha, **kw)

    got = fwd()
    torch.cuda.synchronize()
    want = fwd_plain()
    s1 = fl.ROW_STATS.index("lse_s1")
    if got[1][s1].any() or want[1][s1].any():
        raise AssertionError("K9 computes no CE: lse_s1 must stay 0")
    outs = [("kl", got[0], want[0])] + [(name, a, b) for i, (name, a, b) in
                                        enumerate(zip(fl.ROW_STATS, got[1], want[1])) if i != s1]
    fwd_err = _hold("fused_loca_fwd" + tag, [(lbl, a, b, _kd_bound(b)) for lbl, a, b in outs])
    _bit_identical("fused_loca_fwd" + tag, fwd)
    # K11's LoCa rows and statistics on the same inputs
    kl11, _, st11 = fl.loca_ce_fwd(hs, ws, tmat, lab, lab_ce, alpha=alpha, **kw)
    keep = [i for i in range(len(fl.ROW_STATS)) if i != s1]
    same = torch.equal(got[0], kl11) and torch.equal(got[1][keep], st11[keep])
    log(f"[kernel] fused_loca_fwd{tag}: KL rows and statistics bit-equal to K11's: {same}")
    if not same:
        raise AssertionError("K9's forward is not K11's LoCa part")
    del got, want, kl11, st11

    ones, zeros = torch.ones(n, device=hs.device), torch.zeros(n, device=hs.device)
    dh, dw = fl.loca_bwd(hs, ws, tmat, lab, stats, ones, **kw)
    dh_only, no_dw = fl.loca_bwd(hs, ws, tmat, lab, stats, ones, need_dw=False, **kw)
    torch.cuda.synchronize()
    if no_dw is not None or not torch.equal(dh_only, dh):
        raise AssertionError("K9 without dW gave a dW or another dh")
    want_dh, want_dw = fl.loca_rows_bwd_ref(hs, ws, tmat, lab, stats, ones, **kw)
    bwd_err = _hold("fused_loca_bwd" + tag, [("dh", dh, want_dh, _kd_bound(want_dh)),
                                            ("dW", dw, want_dw, _kd_bound(want_dw))])
    dh11, dw11 = fl.loca_ce_bwd(hs, ws, tmat, lab, lab_ce, stats, ones, zeros, **kw)
    same = torch.equal(dh, dh11) and torch.equal(dw, dw11)
    log(f"[kernel] fused_loca_bwd{tag}: dh and dW bit-equal to K11's with g_ce = 0: {same}")
    if not same:
        raise AssertionError("K9's backward is not K11's with g_ce = 0")
    del dh, dw, dh_only, dh11, dw11
    # a backward that loses the p_sT * tsum term ...
    no_tsum = stats.clone()
    no_tsum[fl.ROW_STATS.index("tsum")] = 0.0
    faulty = fl.loca_bwd(hs, ws, tmat, lab, no_tsum, ones, **kw)
    _must_fail("fused_loca_bwd" + tag, "tsum = 0", list(zip(faulty, (want_dh, want_dw))))
    # ... and one that loses the cotangent of every other row
    half = ones.clone()
    half[::2] = 0.0
    faulty = fl.loca_bwd(hs, ws, tmat, lab, stats, half, **kw)
    _must_fail("fused_loca_bwd" + tag, "g = 0 in half the rows", list(zip(faulty, (want_dh, want_dw))))
    del faulty, want_dh, want_dw, no_tsum

    def bwd():
        return fl.loca_bwd(hs, ws, tmat, lab, stats, ones, **kw)

    def bwd_plain():
        return fl.loca_rows_bwd_ref(hs, ws, tmat, lab, stats, ones, **kw)

    _bit_identical("fused_loca_bwd" + tag, bwd)
    if tag:
        return []
    if parent is not None:
        _same_as_parent(parent, "fused_loca_fwd", fwd, fwd(), must=True)
        _same_as_parent(parent, "fused_loca_bwd", bwd, bwd(), must=True)
        log_in_turns("fused_loca_fwd", _theirs(parent, fwd), fwd, iters=5)
        log_in_turns("fused_loca_bwd", _theirs(parent, bwd), bwd, iters=3)
    got = fwd()
    # no single PyTorch call computes the LoCa rows or their gradient over
    # a streamed head
    results = [_result("fused_loca_fwd", fwd_err, time_ms(fwd, iters=5), time_ms(fwd_plain, iters=2, warmup=1),
                       bound(2 * n * d * vocab, nbytes(hs, ws, tmat, lab, *got))),
               _result("fused_loca_bwd", bwd_err, time_ms(bwd, iters=3), time_ms(bwd_plain, iters=2, warmup=1),
                       bound(6 * n * d * vocab, 2 * nbytes(hs, ws) + nbytes(tmat, lab, stats, ones)))]
    del got
    torch.cuda.empty_cache()
    return results


def kl_kernel_phase(dev, g, parent=None) -> list:
    """K7 and K8 against their plain versions at the phase-1 path's shapes:
    N = 3072 rows, the 896-wide student head of 151936 rows, and the f32
    teacher-logit matrix at 1/T made as the step makes it, one product of a
    random teacher hidden [N, 3584] with a random head [V, 3584] (bf16,
    f32 out; logits of std ~3).  K7 with a negative control (the student's
    1/T dropped: a kernel run at T = 1 against the plain version at T),
    K8 with and without dW and its negative controls; two launches of each
    bit-identical, their splits by kernel; with ``parent``, the parent's
    K7 (bits logged, not held: the kernel is redesigned) and K8 (held
    bit-equal to it, with and without dW) in turns."""
    cfg, tcfg = llava_onevision_0_5b(), llava_onevision_7b()
    n, d, vocab = 3072, cfg.text.hidden_size, cfg.text.vocab_size
    inv_t = 1.0 / kd_loss_config_for("double_trouble").temperature
    hs = torch.randn(n, d, generator=g, device=dev).to(torch.bfloat16)
    ws = (torch.randn(vocab, d, generator=g, device=dev) * 0.05).to(torch.bfloat16)
    th = torch.randn(n, tcfg.text.hidden_size, generator=g, device=dev).to(torch.bfloat16)
    wt = (torch.randn(vocab, tcfg.text.hidden_size, generator=g, device=dev) * 0.05).to(torch.bfloat16)
    tmat = torch.mm(th, wt.T, out_dtype=torch.float32).mul_(inv_t)
    del th, wt

    def bounds(want):
        return KD_TOL * max(1.0, want.float().abs().max().item())

    def fwd():
        return fkl.kl_fwd(hs, ws, tmat, inv_t=inv_t)

    def fwd_plain():
        return fkl.kl_rows_ref(hs, ws, tmat, inv_t=inv_t)

    got = fwd()
    torch.cuda.synchronize()
    want = fwd_plain()
    err = _hold("fused_kl_fwd", [(lbl, a, b, bounds(b)) for lbl, a, b in zip(("kl", "lse_s", "lse_t"), got, want)])
    _must_fail("fused_kl_fwd", "the student's 1/T dropped", list(zip(fkl.kl_fwd(hs, ws, tmat, inv_t=1.0), want)))
    _bit_identical("fused_kl_fwd", fwd)
    _log_split("fused_kl_fwd", fwd, parent)
    if parent is not None:
        _same_as_parent(parent, "fused_kl_fwd", fwd, got, must=False)
        log_in_turns("fused_kl_fwd", _theirs(parent, fwd), fwd, iters=5)
    results = [_result("fused_kl_fwd", err, time_ms(fwd, iters=5), time_ms(fwd_plain, iters=2, warmup=1),
                       bound(2 * n * d * vocab, nbytes(hs, ws, tmat, *got)))]
    _, lse_s, lse_t = want
    del got, want

    # Unit cotangents; dh alone (a frozen head, phase 1) and dh with dW.
    g_kl = torch.ones(n, device=dev)
    want_dh, want_dw = fkl.kl_rows_bwd_ref(hs, ws, tmat, lse_s, lse_t, g_kl, inv_t=inv_t)
    dh, dw = fkl.kl_bwd(hs, ws, tmat, lse_s, lse_t, g_kl, inv_t=inv_t)
    dh_only, no_dw = fkl.kl_bwd(hs, ws, tmat, lse_s, lse_t, g_kl, inv_t=inv_t, need_dw=False)
    torch.cuda.synchronize()
    if no_dw is not None or not torch.equal(dh_only, dh):
        raise AssertionError("K8 without dW gave a dW or another dh")
    err = _hold("fused_kl_bwd", [("dh", dh, want_dh, bounds(want_dh)), ("dW", dw, want_dw, bounds(want_dw))])
    del dh, dw, dh_only
    # a backward against a mis-normalised teacher (lse_t + 1: p_t / e) ...
    faulty = fkl.kl_bwd(hs, ws, tmat, lse_s, lse_t + 1.0, g_kl, inv_t=inv_t)
    _must_fail("fused_kl_bwd", "lse_t + 1", list(zip(faulty, (want_dh, want_dw))))
    # ... and one that loses the cotangent of every other row
    half = g_kl.clone()
    half[::2] = 0.0
    faulty = fkl.kl_bwd(hs, ws, tmat, lse_s, lse_t, half, inv_t=inv_t)
    _must_fail("fused_kl_bwd", "g = 0 in half the rows", list(zip(faulty, (want_dh, want_dw))))
    del faulty, want_dh, want_dw

    def bwd(need_dw=True):
        return fkl.kl_bwd(hs, ws, tmat, lse_s, lse_t, g_kl, inv_t=inv_t, need_dw=need_dw)

    def bwd_dh():
        return bwd(need_dw=False)[0]

    def bwd_plain():
        return fkl.kl_rows_bwd_ref(hs, ws, tmat, lse_s, lse_t, g_kl, inv_t=inv_t)

    _bit_identical("fused_kl_bwd", bwd)
    _bit_identical("fused_kl_bwd without dW", bwd_dh)
    _log_split("fused_kl_bwd", bwd, parent)
    _log_split("fused_kl_bwd without dW", bwd_dh, parent)
    if parent is not None:
        _same_as_parent(parent, "fused_kl_bwd", bwd, bwd(), must=True)
        log_in_turns("fused_kl_bwd", _theirs(parent, bwd), bwd, iters=3)
        log_in_turns("fused_kl_bwd without dW", _theirs(parent, bwd_dh), bwd_dh, iters=3)
    # no single PyTorch call computes the KL rows or their gradient over a
    # streamed head
    results.append(_result("fused_kl_bwd", err, time_ms(bwd, iters=3), time_ms(bwd_plain, iters=2, warmup=1),
                           bound(6 * n * d * vocab,
                                 2 * nbytes(hs, ws) + nbytes(tmat, lse_s, lse_t, g_kl))))
    dh_ms = time_ms(bwd_dh, iters=3)
    dh_bound = bound(4 * n * d * vocab, 2 * nbytes(hs) + nbytes(ws, tmat, lse_s, lse_t, g_kl))
    log(f"[kernel] fused_kl_bwd without dW (a frozen head, as in phase 1): {dh_ms:.4f} ms, "
        f"bound {dh_bound[0]:.4f} ms ({dh_bound[1]})")
    del hs, ws, tmat
    torch.cuda.empty_cache()
    return results


# K12 at the int8 paths' shapes: (label, rows N, K, M, k_block).  The
# first is the one the kernels line reports.
INT8_CASES = [
    ("teacher gate_proj", 3072, 3584, 18944, None),
    ("teacher down_proj", 3072, 18944, 3584, None),
    ("SigLIP fc2, ragged K", 7290, 4304, 1152, None),
    ("student decode gate_proj", 1, 896, 4864, None),
    ("teacher gate_proj, K blocks of 512", 3072, 3584, 18944, i8.pick_block(3584)),
]


def int8_kernel_phase(dev, g, parent=None) -> list:
    """K12 in both activation forms and K10 against their plain versions at
    the int8 paths' shapes, with bounds, plain times and yardsticks (never
    called by the port): for K12 ``torch._int_mm`` on pre-quantized
    operands (the product alone) and bf16 ``torch.mm`` on the dequantized
    weight; for K10 bf16 ``torch.mm`` against the dequantized head, what the
    bf16 head costs.  K12 is held bit-equal to its plain version (exact s32
    sums, the same f32 epilogue), and with ``parent`` to the parent's kernel
    at every shape, timed in turns.  Two negative controls must fail K12's
    bounds: weight scales of 1 in half the columns, and every row scaled by
    the first row's amax."""
    results, worst, first = [], 0.0, None
    for label, n, k, m, kb in INT8_CASES:
        x = torch.randn(n, k, generator=g, device=dev).to(torch.bfloat16)
        wq, ws = i8.absmax_quantize_weight(torch.randn(m, k, generator=g, device=dev) * 0.02)

        def kernel():
            return i8.int8_matmul(x, wq, ws, k_block=kb)

        def plain():
            return i8.int8_matmul_ref(x, wq, ws, k_block=kb)

        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        tol = KERNEL_TOL * max(1.0, want.float().abs().max().item())
        worst = max(worst, _hold(f"int8_mm {label}", [("out", got, want, tol)]))
        log(f"[kernel] int8_mm {label}: bit-equal to its plain version: {torch.equal(got, want)}")
        if not torch.equal(got, want):
            raise AssertionError(f"int8_mm {label} is not bit-equal to its plain version")
        if parent is not None:
            _same_as_parent(parent, f"int8_mm {label}", kernel, got, must=True)
        if first is None:
            bad_ws = ws.clone()
            bad_ws[::2] = 1.0
            _must_fail("int8_mm", "weight scales of 1 in half the columns",
                       [(i8.int8_matmul(x, wq, bad_ws), want)])
            xq = torch.empty(n, k, dtype=torch.int8, device=dev)
            xs = torch.empty(n, 1, dtype=torch.float32, device=dev)
            _build.int8_quantize(x, xq, xs, k, xla_form=True)
            one_row = torch.empty_like(got)
            _build.int8_gemm(xq, xs[:1].expand(n, 1).contiguous(), wq, ws, one_row, k)
            _must_fail("int8_mm", "the first row's amax for every row", [(one_row, want)])
            del bad_ws, one_row
        del got, want
        iters = 200 if n == 1 else 10
        if parent is not None:
            log_in_turns(f"int8_mm {label}", _theirs(parent, kernel), kernel, iters=iters)
        ms = time_ms(kernel, iters=iters)
        plain_ms = time_ms(plain, iters=2, warmup=1)
        least = bound(2 * n * k * m, nbytes(x, wq, ws) + n * m * 2, peak=PEAK_INT8_OPS)
        w_bf16 = (wq.float() * ws[:, None]).to(torch.bfloat16)
        mm_ms = time_ms(lambda: torch.mm(x, w_bf16.T), iters=iters)
        int_mm_ms = None
        if n > 16:  # torch._int_mm takes more than 16 rows
            xq = torch.round(x.float() * (127.0 / x.float().abs().amax(1, keepdim=True))).to(torch.int8)
            int_mm_ms = time_ms(lambda: torch._int_mm(xq, wq.T), iters=iters)
        log(f"[kernel] int8_mm {label} [{n} x {k}] x [{m} x {k}]^T, k_block {kb or k}: kernel {ms:.4f} ms "
            f"({2 * n * k * m / ms / 1e9:.1f} TOP/s), plain {plain_ms:.4f} ms, bound {least[0]:.4f} ms "
            f"({least[1]}), torch._int_mm "
            f"{'n/a' if int_mm_ms is None else f'{int_mm_ms:.4f} ms'}, bf16 torch.mm {mm_ms:.4f} ms")
        if first is None:
            first = (ms, plain_ms, least, int_mm_ms)
        del x, wq, ws, w_bf16
    torch.cuda.empty_cache()
    results.append(_result("int8_mm", worst, first[0], first[1], first[2], first[3]))
    results.append(tmat_kernel_phase(dev, g, parent))
    return results


def tmat_kernel_phase(dev, g, parent=None) -> dict:
    """K10 at the KD path's shape: the teacher's final-norm hidden states
    [3072, 3584] against the first 151936 rows of its int8 head [152128,
    3584], f32 out at 1/T; two launches bit-identical; a negative control
    (scales of 1, a kernel that drops ws) must fail the bounds; with
    ``parent``, the parent's K10 timed in turns."""
    tcfg, scfg = llava_onevision_7b(), llava_onevision_0_5b()
    n, d, vt, vocab = 3072, tcfg.text.hidden_size, tcfg.text.vocab_size, scfg.text.vocab_size
    inv_t = 1.0 / kd_loss_config_for("double_trouble").temperature
    ht = torch.randn(n, d, generator=g, device=dev).to(torch.bfloat16)
    wq, ws = i8.absmax_quantize_weight(torch.randn(vt, d, generator=g, device=dev) * 0.02)

    def kernel():
        return fl.materialize_teacher_logits_int8(ht, wq, ws, inv_t, vocab)

    def plain():
        return fl.materialize_teacher_logits_int8_ref(ht, wq, ws, inv_t, vocab)

    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    err = _hold("tmat_int8", [("tmat", got, want, KERNEL_TOL * max(1.0, want.abs().max().item()))])
    same = torch.equal(got, kernel())
    log(f"[kernel] tmat_int8: two launches bit-identical: {same}")
    if not same:
        raise AssertionError("K10 is not deterministic")
    del got
    _must_fail("tmat_int8", "scales of 1 (ws dropped)",
               [(fl.materialize_teacher_logits_int8(ht, wq, torch.ones_like(ws), inv_t, vocab), want)])
    del want
    if parent is not None:
        _same_as_parent(parent, "tmat_int8", kernel, kernel(), must=True)
        log_in_turns("tmat_int8", _theirs(parent, kernel), kernel, iters=5)
    ms, plain_ms = time_ms(kernel, iters=5), time_ms(plain, iters=2, warmup=1)
    w_bf16 = (wq[:vocab].float() * ws[:vocab, None]).to(torch.bfloat16)
    library = time_ms(lambda: torch.mm(ht, w_bf16.T, out_dtype=torch.float32), iters=5)
    del w_bf16
    least = bound(2 * n * d * vocab, nbytes(ht, wq[:vocab], ws[:vocab]) + n * vocab * 4)
    log(f"[kernel] tmat_int8 [{n} x {d}] x [{vocab} of {vt} x {d}]^T: {2 * n * d * vocab / ms / 1e9:.1f} TFLOP/s, "
        f"{ms / library:.3f}x bf16 torch.mm on the dequantized head, {least[0] / ms:.1%} of its bound")
    del ht, wq, ws
    torch.cuda.empty_cache()
    return _result("tmat_int8", err, ms, plain_ms, least, library)


@contextlib.contextmanager
def plain_int8():
    """Route every QLinear through the plain int8 product
    (``int8_matmul_ref``) on the card: the plain path of the int8 checks."""
    saved = qwen2.int8_matmul
    qwen2.int8_matmul = i8.int8_matmul_ref
    try:
        yield
    finally:
        qwen2.int8_matmul = saved


def _device_batch(batch, dev, streams=("student_",)) -> dict:
    """The batch on the card; the teacher_* (RGB) keys only if asked for."""
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()
            if not k.startswith("teacher_") or "teacher_" in streams}


def _cut(cfg, layers: int = 2):
    """The config at full width with ``layers`` SigLIP and Qwen2 layers."""
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, num_hidden_layers=layers),
        text=dataclasses.replace(cfg.text, num_hidden_layers=layers))


def training_phase(dev, tag: str = "train") -> dict:
    """8 baseline train steps of the 0.5B student, full width and depth."""
    cfg = llava_onevision_0_5b()
    t0 = time.perf_counter()
    model = common.init_or_load_params(cfg, None, seed=0, attn_impl="flash", device=dev,
                                       dtype=torch.bfloat16, trainable=True)
    batch = synthetic_kd_batch(cfg, 1, seq_len=3072, orig_sizes=[(530, 730)], accum=ACCUM, seed=3)
    tb = _device_batch(batch, dev)
    tcfg = TrainConfig(kd_mode="baseline", accumulate_grad_batches=ACCUM, learning_rate=LR,
                       cosine_t_max=0, ce_impl="fused")
    state = TrainState(model, make_optimizer(model, LR))
    step = make_train_step(KDModels(model), tcfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[{tag}] model ({n_params / 1e6:.1f} M params, bf16; float32 masters) + batch set-up "
        f"{time.perf_counter() - t0:.1f} s; A={ACCUM} x B=1, "
        f"{int(tb['student_attention_mask'][0].sum())} tokens in a {tb['student_input_ids'].shape[-1]} bucket")

    probe_w0 = state.optimizer.masters[MASTER_PROBE].clone()
    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, times = [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, None, tb)
        loss = metrics["loss"].item()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        if i == 0:
            probe_moved = _master_moved(state, probe_w0)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    per_step = {"flash_fwd_mha": cfg.vision.num_hidden_layers, "flash_fwd_gqa": cfg.text.num_hidden_layers,
                "flash_bwd_mha": cfg.vision.num_hidden_layers, "flash_bwd_gqa": cfg.text.num_hidden_layers,
                "fused_ce_fwd": 1, "fused_ce_bwd": 1}
    want = {k: per_step.get(k, 0) * ACCUM * TRAIN_STEPS for k in COUNTERS}
    log(f"[{tag}] launches over {TRAIN_STEPS} steps: {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"training launch counts {launches} != {want}")
    timed = times[WARMUP_STEPS:]
    step_ms = sum(timed) / len(timed)
    log(f"[{tag}] loss per step: {', '.join(f'{x:.6f}' for x in losses)}")
    log(f"[{tag}] step ms: {', '.join(f'{x:.1f}' for x in times)}; mean of the {len(timed)} steps after "
        f"{WARMUP_STEPS} warm-up steps {step_ms:.1f} ms (min {min(timed):.1f}, max {max(timed):.1f}), "
        f"{ACCUM / (step_ms / 1e3):.3f} samples/s; peak memory "
        f"{peak / 2**30:.2f} GiB (max_memory_allocated)")
    frac, mean_step = probe_moved
    log(f"[{tag}] float32 master of {MASTER_PROBE}, entries with 0.015 <= |w| <= 0.025: "
        f"{frac:.4f} moved on step 1, mean |update| {mean_step:.3e} (lr {LR})")
    if not (frac >= 0.9 and 0.5 * LR <= mean_step <= 1.5 * LR):
        raise AssertionError(f"an update of ~lr did not reach the float32 master: {probe_moved}")
    if not all(x == x and abs(x) < float("inf") for x in losses):
        raise AssertionError(f"non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall over {TRAIN_STEPS} steps: {losses}")
    del state, step, model, tb
    torch.cuda.empty_cache()
    return dict(launches=launches, losses=losses, step_ms=step_ms, peak=peak)


def _master_moved(state, w0):
    """(fraction moved, mean |update|) over the probe's float32 master entries
    with 0.015 <= |w| <= 0.025; also checks that the bf16 weight is the
    master cast to bf16."""
    master = state.optimizer.masters[MASTER_PROBE]
    param = state.optimizer.params[MASTER_PROBE]
    if master.dtype != torch.float32 or not torch.equal(param, master.to(param.dtype)):
        raise AssertionError("the bf16 weight is not its float32 master cast to bf16")
    sel = (w0.abs() >= 0.015) & (w0.abs() <= 0.025)
    upd = (master - w0).abs()[sel]
    return (upd > 0).float().mean().item(), upd.mean().item()


def agreement_phase(dev) -> None:
    """Kernel path vs plain path at full width and 2 SigLIP + 2 Qwen2 layers
    (so the plain path's f32 probabilities and logits fit): the loss, and
    the gradients of the embedding, one q_proj and one SigLIP fc1."""
    cfg = _cut(llava_onevision_0_5b())
    model = common.init_or_load_params(cfg, None, seed=1, attn_impl="flash", device=dev,
                                       dtype=torch.bfloat16, trainable=True)
    batch = synthetic_kd_batch(cfg, 1, seq_len=3072, orig_sizes=[(530, 730)], seed=3)
    tb = _device_batch(batch, dev)
    names = ("language_model.embed_tokens.weight", "language_model.layers.0.self_attn.q_proj.weight",
             "vision_tower.layers.0.mlp.fc1.weight")
    params = dict(model.named_parameters())
    leaves = [params[n] for n in names]

    reset_counts()
    loss_k, _ = make_loss_fn(KDModels(model), TrainConfig(kd_mode="baseline", ce_impl="fused"))(tb)
    grads_k = torch.autograd.grad(loss_k, leaves)
    launches = read_counts()
    for k in ("flash_fwd_mha", "flash_fwd_gqa", "flash_bwd_mha", "flash_bwd_gqa", "fused_ce_fwd", "fused_ce_bwd"):
        if launches[k] == 0:
            raise AssertionError(f"the kernel path skipped {k}: {launches}")

    set_attn_impl(model, "xla")
    _, _, _, hidden = model(
        input_ids=tb["student_input_ids"], attention_mask=tb["student_attention_mask"],
        pixel_values=tb["student_pixel_values"], pack_idx=tb["pack_idx"],
        pack_weight=tb["pack_weight"], pack_valid=tb["pack_valid"], tile_valid=tb["tile_valid"],
        return_hidden=True, compute_logits=False)
    logits = hidden.float() @ model.language_model.embed_tokens.weight.float().T
    loss_p = masked_cross_entropy(logits, tb["labels"])
    grads_p = torch.autograd.grad(loss_p, leaves)
    del logits, hidden

    rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    log(f"[agree] 2+2 layers, full width: loss kernel path {loss_k.item():.6f}, plain path "
        f"{loss_p.item():.6f}, rel diff {rel:.3e} (tol {LOSS_REL_TOL})")
    if not (rel <= LOSS_REL_TOL):
        raise AssertionError(f"kernel and plain paths disagree on the loss: {rel}")
    for n, gk, gp in zip(names, grads_k, grads_p):
        cos = _cosine(gk, gp)
        log(f"[agree] grad {n}: cosine {cos:.6f} (tol {GRAD_COSINE}), "
            f"norms {gk.float().norm().item():.4e} / {gp.float().norm().item():.4e}")
        if not (cos >= GRAD_COSINE):
            raise AssertionError(f"kernel and plain gradients of {n} disagree: cosine {cos}")
    del model, grads_k, grads_p
    torch.cuda.empty_cache()


def _build_teacher(dev):
    """The frozen bf16 LLaVA-OneVision-7B teacher at full width and depth,
    built once and shared by the KD paths."""
    t0 = time.perf_counter()
    teacher = common.init_or_load_params(llava_onevision_7b(), None, seed=1, attn_impl="flash", device=dev,
                                         dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_t = sum(p.numel() for p in teacher.parameters())
    log(f"[kd] teacher ({n_t / 1e9:.3f} B params, bf16, frozen) set-up {time.perf_counter() - t0:.1f} s")
    return teacher


def kd_path(dev, teacher, tag: str, mode: str, phase: int, steps: int, per_micro: dict,
            vision_moves: bool = False, faithful: bool = False, probe=None) -> dict:
    """``steps`` KD train steps of the 0.5B student (a fresh one, full width
    and depth) in ``mode``/``phase`` against the frozen ``teacher``: exact
    launch counts (``per_micro`` per micro-batch), a finite and falling loss,
    the mean time of the steps after the first ``KD_WARMUP``, samples/s and
    peak memory; that every parameter the phase freezes kept its bits and,
    with ``vision_moves``, that every float32 master of the vision tower and
    the projector moved.  ``faithful`` sets ``loca_faithful_indexing``;
    ``probe(student, tb)``, if given, runs after the steps and its result
    is returned under "probe"."""
    scfg = llava_onevision_0_5b()
    t0 = time.perf_counter()
    student = common.init_or_load_params(scfg, None, seed=0, attn_impl="flash", device=dev,
                                         dtype=torch.bfloat16, trainable=True)
    batch = synthetic_kd_batch(scfg, 1, seq_len=3072, orig_sizes=[(530, 730)], accum=ACCUM, seed=3)
    tb = _device_batch(batch, dev, streams=("student_", "teacher_"))
    loss = dataclasses.replace(kd_loss_config_for(mode), loca_faithful_indexing=faithful)
    cfg = TrainConfig(kd_mode=mode, phase=phase, loss=loss, accumulate_grad_batches=ACCUM,
                      learning_rate=KD_LR, cosine_t_max=0, ce_impl="fused")
    state = TrainState(student, make_optimizer(student, KD_LR, kd_mode=mode, phase=phase))
    step = make_train_step(KDModels(student, teacher), cfg)
    torch.cuda.synchronize()
    n_s = sum(p.numel() for p in student.parameters())
    log(f"[{tag}] {mode} phase {phase}{', faithful LoCa' if faithful else ''}: student ({n_s / 1e6:.1f} M params, bf16; float32 masters) + batch "
        f"set-up {time.perf_counter() - t0:.1f} s; memory after set-up "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB; A={ACCUM} x B=1, "
        f"{int(tb['student_attention_mask'][0].sum())} tokens in a {tb['student_input_ids'].shape[-1]} bucket")
    # host copies (so that the peak on the card stays the step's own): the
    # frozen parameters, and the masters of the vision side where it trains
    frozen = {n: p.detach().to("cpu", copy=True) for n, p in student.named_parameters()
              if n not in state.optimizer.params}
    vision = ("vision_tower.", "multi_modal_projector.")
    masters0 = {n: m.detach().to("cpu", copy=True) for n, m in state.optimizer.masters.items()
                if vision_moves and n.startswith(vision)}

    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, times, parts = [], [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, None, tb)
        loss = metrics["loss"].item()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        parts.append({k: v.item() for k, v in metrics.items() if k != "loss"})
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    want = {k: per_micro.get(k, 0) * ACCUM * steps for k in COUNTERS}
    log(f"[{tag}] launches over {steps} steps: {launches} (expected {want}; flash_fwd_mha counts "
        f"the student's and the teacher's SigLIP)")
    if launches != want:
        raise AssertionError(f"{mode} phase {phase} launch counts {launches} != {want}")
    timed = times[KD_WARMUP:]
    step_ms = sum(timed) / len(timed)
    log(f"[{tag}] loss per step: {', '.join(f'{x:.6f}' for x in losses)}")
    log(f"[{tag}] terms per step: " + ", ".join(
        "(" + ", ".join(f"{k} {v:.6e}" for k, v in p.items()) + ")" for p in parts))
    log(f"[{tag}] step ms: {', '.join(f'{x:.1f}' for x in times)}; mean of steps {KD_WARMUP + 1}-{steps} "
        f"{step_ms:.1f} ms (min {min(timed):.1f}, max {max(timed):.1f}), "
        f"{ACCUM / (step_ms / 1e3):.3f} samples/s; peak memory {peak / 2**30:.2f} GiB (max_memory_allocated)")
    if not all(x == x and abs(x) < float("inf") for x in losses):
        raise AssertionError(f"non-finite {mode} phase {phase} loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{mode} phase {phase} loss did not fall over {steps} steps: {losses}")
    kept = [n for n, p in student.named_parameters() if n in frozen and torch.equal(p.detach().cpu(), frozen[n])]
    moved = [n for n, m in state.optimizer.masters.items() if n in masters0 and not torch.equal(m.cpu(), masters0[n])]
    roots = sorted({n.split(".", 1)[0] for n in frozen})
    log(f"[{tag}] frozen: {len(kept)} of {len(frozen)} parameters ({', '.join(roots) or 'none'}) kept their "
        f"bits; vision tower + projector: {len(moved)} of {len(masters0)} float32 masters moved")
    if len(kept) != len(frozen) or len(moved) != len(masters0):
        raise AssertionError(f"{mode} phase {phase}: a frozen parameter moved or a trained master did not")
    del state, step
    out = dict(launches=launches, losses=losses, step_ms=step_ms, peak=peak)
    if probe is not None:
        out["probe"] = probe(student, tb)
    del student, tb
    torch.cuda.empty_cache()
    return out


def _kd_per_micro(**loss_kernels) -> dict:
    """Launches per KD micro-batch: the flash kernels of both models (K1 for
    both SigLIP towers, the student's K3/K2/K4, the teacher's K3 at d=128),
    then the loss's own."""
    v, t = llava_onevision_0_5b().vision.num_hidden_layers, llava_onevision_0_5b().text.num_hidden_layers
    return {"flash_fwd_mha": 2 * v, "flash_fwd_gqa": t,
            "flash_fwd_gqa_d128": llava_onevision_7b().text.num_hidden_layers,
            "flash_bwd_mha": v, "flash_bwd_gqa": t, **loss_kernels}


def kd_training_phase(dev, teacher, tag: str = "kd") -> dict:
    """6 double-trouble phase-3 steps: K11 for LoCa + CE."""
    return kd_path(dev, teacher, tag, "double_trouble", 3, KD_STEPS,
                   _kd_per_micro(fused_loca_ce_fwd=1, fused_loca_ce_bwd=1))


def kd_faithful_phase(dev, teacher) -> dict:
    """[kdF]: 6 double-trouble phase-3 steps with ``loca_faithful_indexing``
    (the reference's full-tensor LoCa writes): LoCa from
    ``losses/chunked.py::chunked_faithful_loca`` over the step's f32 teacher
    logits, CE through K5/K6, K11 not launched.  Then K9's op path on one
    micro-batch of the trained student (``loca_op_path``)."""
    return kd_path(dev, teacher, "kdF", "double_trouble", 3, KD_STEPS,
                   _kd_per_micro(fused_ce_fwd=1, fused_ce_bwd=1), faithful=True,
                   probe=lambda student, tb: loca_op_path(student, teacher, tb))


def loca_op_path(student, teacher, tb) -> dict:
    """K9's path, the op API ``ops/fused_loca.py::fused_loca_loss`` (the JAX
    ``fused_loca_loss``; no train step calls it), on the first micro-batch
    of [kdF]: the student's final-norm hidden states [3072, 896] and its
    tied head, the teacher's f32 logits at 1/T, the unshifted labels.  The
    counts are set to 0 just before its forward and backward and read just
    after; then its value and gradients are held to K11's LoCa term (its
    backward with g_ce = 0) on the same inputs."""
    lc = kd_loss_config_for("double_trouble")
    micro = {k: v[0] for k, v in tb.items()}
    with torch.no_grad():
        s_hidden, _ = kd_step._forward_hidden(student, micro, "student")
        head = student.language_model.embed_tokens.weight
        tmat, _ = kd_step._teacher_logits(teacher, micro, head.shape[0], lc.temperature)
    flat = s_hidden.reshape(-1, s_hidden.shape[-1]).detach().requires_grad_(True)
    w = head.detach().requires_grad_(True)
    labels = micro["labels"].reshape(-1)
    kw = dict(temperature=lc.temperature, alpha=lc.loca_alpha)

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loca9 = fl.fused_loca_loss(flat, w, tmat, labels, **kw)
    g9 = torch.autograd.grad(loca9, (flat, w))
    torch.cuda.synchronize()
    op_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    want = dict.fromkeys(COUNTERS, 0)
    want.update(fused_loca_fwd=1, fused_loca_bwd=1)
    log(f"[kdF-op] fused_loca_loss on a [kdF] micro-batch ({flat.shape[0]} rows): loss {loca9.item():.6e}, "
        f"forward + backward {op_ms:.1f} ms (host clock); launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"K9 op path launch counts {launches} != {want}")
    loca11, _ = fl.fused_loca_ce_loss(flat, w, tmat, labels, kd_step.ce_labels(micro["labels"]), **kw)
    g11 = torch.autograd.grad(loca11, (flat, w))
    rel = abs(loca9.item() - loca11.item()) / abs(loca11.item())
    log(f"[kdF-op] K9 vs K11's LoCa term: {loca9.item():.9e} vs {loca11.item():.9e}, rel diff {rel:.3e}; "
        f"dh and dW bit-equal: {all(torch.equal(a, b) for a, b in zip(g9, g11))}")
    if not (math.isfinite(loca9.item()) and rel <= 1e-5):
        raise AssertionError(f"K9 and K11 disagree on the LoCa term: {loca9.item()} vs {loca11.item()}")
    _hold("kdF-op K9 vs K11 gradients", [
        (name, a, b, KD_TOL * max(1.0, b.float().abs().max().item())) for name, a, b in zip(("dh", "dW"), g9, g11)])
    del tmat, flat, w, g9, g11
    return dict(launches=launches, ms=op_ms)


def kd_phase1_phase(dev, teacher, tag: str = "kd1") -> dict:
    """6 double-trouble phase-1 steps (the KD CLI's default): K7 and K8's dh
    for the temperature KL, no dW (the tied head is part of the frozen
    language model), and the flash backwards through the frozen LM into the
    projector and the vision tower."""
    return kd_path(dev, teacher, tag, "double_trouble", 1, KD_STEPS,
                   _kd_per_micro(fused_kl_fwd=1, fused_kl_bwd=1), vision_moves=True)


def feature_based_phase(dev, teacher, tag: str = "kdfb") -> dict:
    """4 feature_based steps: K7, K8 with dW (the head trains), and the fused
    CE K5/K6."""
    return kd_path(dev, teacher, tag, "feature_based", 0, FB_STEPS,
                   _kd_per_micro(fused_kl_fwd=1, fused_kl_bwd=1, fused_kl_bwd_dw=1, fused_ce_fwd=1,
                                 fused_ce_bwd=1))


def _check_agreement(tag: str, names, terms) -> None:
    """Each (label, kernel value, plain value, kernel grads, plain grads) of
    ``terms``: value rel. diff <= LOSS_REL_TOL, gradient cosine >=
    GRAD_COSINE for each parameter of ``names``."""
    for term, vk, vp, gks, gps in terms:
        rel = abs(vk.item() - vp.item()) / abs(vp.item())
        log(f"[{tag}] 2+2 layers of each model, full width: {term} kernel path {vk.item():.6e}, "
            f"plain path {vp.item():.6e}, rel diff {rel:.3e} (tol {LOSS_REL_TOL})")
        if not (rel <= LOSS_REL_TOL):
            raise AssertionError(f"kernel and plain KD paths disagree on the {term}: {rel}")
        for n, gk, gp in zip(names, gks, gps):
            cos = _cosine(gk, gp)
            log(f"[{tag}] {term} grad {n}: cosine {cos:.6f} (tol {GRAD_COSINE}), "
                f"norms {gk.float().norm().item():.4e} / {gp.float().norm().item():.4e}")
            if not (cos >= GRAD_COSINE):
                raise AssertionError(f"kernel and plain KD gradients ({term}) of {n} disagree: cosine {cos}")


def _plain_forward(model, tb, prefix):
    """(final-norm hidden, per-tile vision features) on the plain path."""
    set_attn_impl(model, "xla")
    _, vis, _, hidden = model(
        input_ids=tb[f"{prefix}_input_ids"], attention_mask=tb[f"{prefix}_attention_mask"],
        pixel_values=tb[f"{prefix}_pixel_values"], pack_idx=tb["pack_idx"],
        pack_weight=tb["pack_weight"], pack_valid=tb["pack_valid"], tile_valid=tb["tile_valid"],
        return_hidden=True, compute_logits=False)
    return hidden, vis


def _agreement_models(dev):
    """Student and teacher at full width and 2 SigLIP + 2 Qwen2 layers, the
    batch with both streams."""
    scfg, tcfg = _cut(llava_onevision_0_5b()), _cut(llava_onevision_7b())
    student = common.init_or_load_params(scfg, None, seed=1, attn_impl="flash", device=dev,
                                         dtype=torch.bfloat16, trainable=True)
    teacher = common.init_or_load_params(tcfg, None, seed=2, attn_impl="flash", device=dev,
                                         dtype=torch.bfloat16)
    batch = synthetic_kd_batch(scfg, 1, seq_len=3072, orig_sizes=[(530, 730)], seed=3)
    return student, teacher, _device_batch(batch, dev, streams=("student_", "teacher_"))


def kd_agreement_phase(dev, int8: bool = False, faithful: bool = False) -> None:
    """The KD loss and gradients on the kernel path against dense float32
    LoCa + masked CE on the plain path (plain attention, full logits), at
    full width and 2 SigLIP + 2 Qwen2 layers of each model; with ``int8``
    the teacher quantized as in [kd8] (K12 and K10 on the kernel path, the
    plain int8 product and the dequantized head on the plain path); with
    ``faithful`` the faithful LoCa as in [kdF] (``chunked_faithful_loca``
    and K5/K6 on the kernel path, dense ``loca_loss(faithful_indexing=True)``
    on the plain path)."""
    student, teacher, tb = _agreement_models(dev)
    tag = "kd8-agree" if int8 else "kdF-agree" if faithful else "kd-agree"
    if int8:
        i8.quantize_model_int8(teacher, include_vision=True, include_embed_head=True)
    loss = dataclasses.replace(kd_loss_config_for("double_trouble"), loca_faithful_indexing=faithful)
    cfg = TrainConfig(kd_mode="double_trouble", phase=3, loss=loss, ce_impl="fused")
    lc = cfg.loss
    names = ("language_model.embed_tokens.weight", "language_model.layers.0.self_attn.q_proj.weight",
             "vision_tower.layers.0.mlp.fc1.weight")
    params = dict(student.named_parameters())
    leaves = [params[n] for n in names]

    reset_counts()
    loss_k, _ = make_loss_fn(KDModels(student, teacher), cfg)(tb)
    grads_k = torch.autograd.grad(loss_k, leaves)
    # The LoCa term alone (~1e-5 of the loss: it is normalised by N * V), by
    # the step's own pieces, so that the check can see it under the CE.
    s_hidden, _ = kd_step._forward_hidden(student, tb, "student")
    head = student.language_model.embed_tokens.weight
    tmat, _ = kd_step._teacher_logits(teacher, tb, head.shape[0], lc.temperature)
    flat = s_hidden.reshape(-1, s_hidden.shape[-1])
    if faithful:
        loca_k = chunked_faithful_loca(flat, head, tb["labels"].reshape(-1), tmat, temperature=lc.temperature,
                                       alpha=lc.loca_alpha, chunk_size=cfg.loss_chunk_size)
    else:
        loca_k, _ = fl.fused_loca_ce_loss(flat, head, tmat, tb["labels"].reshape(-1),
                                          kd_step.ce_labels(tb["labels"]), temperature=lc.temperature,
                                          alpha=lc.loca_alpha)
    del tmat, flat
    loca_grads_k = torch.autograd.grad(loca_k, leaves)
    launches = read_counts()
    loss_kernels = ("fused_ce_fwd", "fused_ce_bwd") if faithful else ("fused_loca_ce_fwd", "fused_loca_ce_bwd")
    for k in ("flash_fwd_mha", "flash_fwd_gqa", "flash_fwd_gqa_d128", "flash_bwd_mha", "flash_bwd_gqa",
              *loss_kernels) + (("int8_mm", "tmat_int8") if int8 else ()):
        if launches[k] == 0:
            raise AssertionError(f"the KD kernel path skipped {k}: {launches}")
    if faithful and launches["fused_loca_ce_fwd"] + launches["fused_loca_ce_bwd"]:
        raise AssertionError(f"the faithful path launched K11: {launches}")

    with torch.no_grad(), plain_int8():
        head_t = kd_step.dense_teacher_head(kd_step.teacher_head(teacher), torch.float32).float()
        t_logits = _plain_forward(teacher, tb, "teacher")[0].float() @ head_t.T
        del head_t
    s_logits = _plain_forward(student, tb, "student")[0].float() @ head.float().T
    loca = loca_loss(t_logits, s_logits, tb["labels"], lc.temperature, lc.loca_alpha, faithful_indexing=faithful)
    ce = masked_cross_entropy(s_logits, tb["labels"])
    loss_p = lc.gamma * (loca + ce) + (1.0 - lc.gamma) * ce
    del t_logits
    grads_p = torch.autograd.grad(loss_p, leaves, retain_graph=True)
    loca_grads_p = torch.autograd.grad(loca, leaves)
    del s_logits, ce

    _check_agreement(tag, names, (("loss", loss_k, loss_p, grads_k, grads_p),
                                  ("LoCa term", loca_k, loca, loca_grads_k, loca_grads_p)))
    del student, teacher, grads_k, grads_p, loca_grads_k, loca_grads_p, loca
    torch.cuda.empty_cache()


def kd_phase1_agreement_phase(dev) -> None:
    """The phase-1 loss (0.1 KL + 0.5 NT-Xent) and its gradients on the
    kernel path against dense float32 ``kd_kl_loss`` + ``masked_ntxent_loss``
    on the plain path, at full width and 2 SigLIP + 2 Qwen2 layers of each
    model; and the KL term alone, which its 1 / (N V) normalisation makes
    tiny beside NT-Xent."""
    student, teacher, tb = _agreement_models(dev)
    cfg = TrainConfig(kd_mode="double_trouble", phase=1, loss=kd_loss_config_for("double_trouble"),
                      ce_impl="fused")
    lc = cfg.loss
    names = ("vision_tower.layers.0.mlp.fc1.weight", "multi_modal_projector.linear_1.weight",
             "vision_tower.layers.0.self_attn.q_proj.weight")
    params = dict(student.named_parameters())
    leaves = [params[n] for n in names]

    reset_counts()
    loss_k, _ = make_loss_fn(KDModels(student, teacher), cfg)(tb)
    grads_k = torch.autograd.grad(loss_k, leaves)
    s_hidden, _ = kd_step._forward_hidden(student, tb, "student")
    head = student.language_model.embed_tokens.weight
    tmat, _ = kd_step._teacher_logits(teacher, tb, head.shape[0], lc.temperature)
    kl_k = fkl.fused_kl_loss(s_hidden.reshape(-1, s_hidden.shape[-1]), head, tmat, temperature=lc.temperature)
    del tmat
    kl_grads_k = torch.autograd.grad(kl_k, leaves)
    launches = read_counts()
    for k in ("flash_fwd_mha", "flash_fwd_gqa", "flash_fwd_gqa_d128", "flash_bwd_mha", "flash_bwd_gqa",
              "fused_kl_fwd", "fused_kl_bwd"):
        if launches[k] == 0:
            raise AssertionError(f"the phase-1 kernel path skipped {k}: {launches}")

    with torch.no_grad():
        t_hidden, t_vis = _plain_forward(teacher, tb, "teacher")
        t_logits = t_hidden.float() @ teacher.language_model.lm_head.weight.float().T
    s_hidden, s_vis = _plain_forward(student, tb, "student")
    kl = kd_kl_loss(s_hidden.float() @ head.float().T, t_logits, lc.temperature)
    con = masked_ntxent_loss(s_vis.flatten(0, 1).float(), t_vis.flatten(0, 1).float(),
                             tb["tile_valid"].reshape(-1), lc.ntxent_temperature)
    loss_p = lc.soft_target_weight * kl + lc.contrastive_weight * con
    del t_logits
    grads_p = torch.autograd.grad(loss_p, leaves, retain_graph=True)
    kl_grads_p = torch.autograd.grad(kl, leaves)

    _check_agreement("kd1-agree", names, (("loss", loss_k, loss_p, grads_k, grads_p),
                                          ("KL term", kl_k, kl, kl_grads_k, kl_grads_p)))
    del student, teacher, grads_k, grads_p, kl_grads_k, kl_grads_p, kl, con
    torch.cuda.empty_cache()


# [tiny]: (label, CLI module, its extra flags)
TINY_RUNS = (
    ("baseline_depth", "train", ()),
    ("KD double_trouble phase 1 (the CLI's default)", "train_online_kd", ()),
    ("KD phase 2, faithful LoCa, DAQUAR", "train_online_kd",
     ("--phase", "2", "--loca_faithful_indexing", "--dataset", "daquar")),
)


def tiny_cli_phase() -> None:
    """[tiny]: the baseline and KD CLIs with ``--synthetic_data`` and
    neither ``--real_model`` nor ``--cpu``: the tiny configs train on the
    card.  Their width and head dims are not the kernels', so the CLIs pick
    the plain routes from the configs (``common.resolve_ce_impl``,
    ``common.resolve_attn_impl``) and no kernel launches.  Data and
    checkpoints go to build/chip_smoke_tiny/ in this checkout."""
    import importlib
    import re
    import shutil

    root = _build.BUILD_DIR.parent / "chip_smoke_tiny"
    shutil.rmtree(root, ignore_errors=True)
    for label, cli, extra in TINY_RUNS:
        mod = importlib.import_module(f"{PKG}.cli.{cli}")
        d = root / cli / str(len(extra))
        r = _run_cli("tiny", mod, ["--synthetic_data", "--accumulate_grad_batches", "1", "--num_workers", "1",
                                   "--root_data_dir", str(d / "data"), "--checkpoint_dir", str(d / "ck"),
                                   "--tensorboard_dir", str(d / "tb"), *extra])
        launches = {k: v for k, v in r["launches"].items() if v}
        val = [float(x) for x in re.findall(r"val_loss (\S+)", r["log"])]
        log(f"[tiny] {cli} {' '.join(extra)}: {label}, {r['wall']:.1f} s; val_loss {val}; kernel launches {launches}")
        if len(val) != 1 or not math.isfinite(val[0]) or "training complete" not in r["log"]:
            raise AssertionError(f"the tiny {cli} run did not finish: {r['log'][-2000:]}")
        if launches:
            raise AssertionError(f"the tiny {cli} run launched kernels: {launches}")
    shutil.rmtree(root, ignore_errors=True)


# [eval]: the evaluator CLI on a synthetic SUNRGBD split of 21 rows whose
# frames cycle through the dataset's four sensor sizes (h, w): kv2 730x530,
# kv1 561x427, realsense 681x531, xtion 640x480.  Their anyres grids differ,
# so prompts in one batch differ by hundreds of tokens and K3's kv mask
# masks.  B=8 gives batches of 8, 8 and a 5-row tail padded to 8.
EVAL_ROWS = 21
EVAL_BS = 8
EVAL_SIZES = ((530, 730), (427, 561), (531, 681), (480, 640))
EVAL_7B_ROWS, EVAL_7B_BS = 0.2, 2  # --subset_percentage 0.2: 4 rows, 2 batches of 2


def _eval_tree(root) -> str:
    """common.ensure_synthetic_dataset's layout and CSVs, its images redrawn
    at the sensor frame sizes (seeded)."""
    import numpy as np
    from PIL import Image

    common.ensure_synthetic_dataset(str(root), n=EVAL_ROWS)
    rng = np.random.default_rng(21)
    img = root / "SUNRGBD" / "img"
    for i in range(EVAL_ROWS):
        h, w = EVAL_SIZES[i % len(EVAL_SIZES)]
        Image.fromarray(rng.integers(0, 255, size=(h, w, 3)).astype(np.uint8)).save(img / f"rgb_{i}.png")
        Image.fromarray(rng.integers(0, 65535, size=(h, w)).astype(np.uint16)).save(img / f"d_{i}.png")
    return str(root)


def _run_eval(tag, root, preds, *flags) -> dict:
    """One evaluator CLI run (``_run_cli``): its rows, wall time, launch
    counts from 0 and peak memory."""
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli import (
        evaluate_onevision,
    )

    r = _run_cli(tag, evaluate_onevision, ["--root_data_dir", root, "--predictions_dir", str(preds),
                                          "--max_new_tokens", str(N_NEW), "--metric_backend", "hashed", *flags])
    r.update(r.pop("ret"))
    rows = len(r["rows"])
    log(f"[{tag}] {' '.join(flags)}: {rows} rows in {r['wall']:.1f} s ({rows / r['wall']:.3f} rows/s); host "
        f"(rows read, depth, anyres, collation) {r['host_s']:.2f} s, generate {r['generate_s']:.2f} s; "
        f"peak memory {r['peak'] / 2**30:.2f} GiB")
    return r


def _run_cli(tag, mod, argv) -> dict:
    """One CLI ``main`` (its output captured): what it returned, its launch
    counts from 0, wall time and peak memory."""
    import gc
    import io

    out = io.StringIO()
    gc.collect()  # an earlier run's models (FSDP2 hooks make cycles) are not this run's memory
    torch.cuda.empty_cache()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        ret = mod.main(argv)
    torch.cuda.synchronize()
    r = dict(ret=ret, wall=time.perf_counter() - t0, launches=read_counts(), peak=torch.cuda.max_memory_allocated(),
             log=out.getvalue())
    log(f"[{tag}] {mod.__name__.rsplit('.', 1)[1]}: {r['wall']:.1f} s, peak memory {r['peak'] / 2**30:.2f} GiB, "
        f"kernel launches { {k: v for k, v in r['launches'].items() if v} }")
    return r


def _hold_launches(tag, got, per_batch, batches) -> None:
    want = dict.fromkeys(COUNTERS, 0)
    want.update({k: n * batches for k, n in per_batch.items()})
    log(f"[{tag}] launches over {batches} batches: { {k: v for k, v in got.items() if v} } (expected, "
        f"every other counter 0: { {k: v for k, v in want.items() if v} })")
    if got != want:
        raise AssertionError(f"{tag} launch counts {got} != {want}")


def _eval_next_logits(model, cfg, root, bs) -> list:
    """Each row's prefill next-token logits (f32, on the host), from batches
    of ``bs`` rows collated as the evaluator collates them."""
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.data.collate import (
        OneVisionCollator,
    )
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.data.dataset import (
        SUNRGBDVQADataset,
    )

    ds = SUNRGBDVQADataset(root, "val_dataset.csv", depth_encoding="prewitt_imagenet")
    tok = common.make_tokenizer(types.SimpleNamespace(tokenizer_path=None), cfg)
    collator = OneVisionCollator(cfg, tok, eval_mode=True)
    gen = Generator(cfg, GenerateConfig(max_new_tokens=N_NEW, eos_token_id=cfg.eos_token_id))
    rows = []
    for start in range(0, len(ds), bs):
        n = min(bs, len(ds) - start)
        samples = [ds[i] for i in range(start, start + n)]
        batch = collator(samples + [samples[-1]] * (bs - n))
        tb = {k: torch.as_tensor(v, device=model.device) for k, v in batch.items()
              if not k.startswith("teacher_") and k != "question_id"}
        with torch.no_grad():
            logits, _, lengths = gen.prefill(model, tb)
            rows += [logits[j, int(lengths[j]) - 1].float().cpu() for j in range(n)]
        del logits
    return rows


def eval_phase(dev, parent=None) -> dict:
    """[eval]: ``cli/evaluate_onevision.py``'s main on the card with the 0.5B
    student at full width and depth (seeded random weights) on the
    21-row split of ``_eval_tree``: at B=8 and B=1 with exact K1/K3 launch
    counts (the prefill only); the rows of B=8 those of B=1 (same
    Question_Ids, no pad row), each row's prefill next-token logits at B=8
    held to B=1's (max abs error <= KERNEL_TOL x max(1, max |logit|),
    relative Frobenius error <= REL_FRO_TOL), and its generated tokens equal
    or, from the first step where they differ, B=1's top-2 margin there
    within twice that logit bound (two logits each off by up to the bound can
    swap); a checkpoint restore (the CSV of a model built from seed 1 with
    the seed-0 model's checkpoint equals the seed-0 run's, and without it
    differs); ``--quant int8_full`` at B=8 with exact K12 counts; the 7B
    (``--model_id ...7b``, bf16, 28 layers) on 4 rows at B=2 with exact
    K3-d128 counts; ``get_all_results`` over the predictions.  With
    ``parent``, B=8 again with the parent's kernels and then with this
    checkout's (rows/s in turns)."""
    import io
    import shutil

    import pandas as pd

    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli import (
        get_all_results,
    )
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.train.checkpoint import (
        CheckpointManager,
    )

    cfg, tcfg = llava_onevision_0_5b(), llava_onevision_7b()
    base = _build.BUILD_DIR.parent / "chip_smoke_eval"
    shutil.rmtree(base, ignore_errors=True)
    root = _eval_tree(base / "data")
    vis, txt = cfg.vision.num_hidden_layers, cfg.text.num_hidden_layers
    per_batch = {"flash_fwd_mha": vis, "flash_fwd_gqa": txt}
    n_batches = -(-EVAL_ROWS // EVAL_BS)

    r8 = _run_eval("eval", root, base / "p8", "--eval_batch_size", str(EVAL_BS))
    _hold_launches("eval", r8["launches"], per_batch, n_batches)
    r1 = _run_eval("eval", root, base / "p1", "--eval_batch_size", "1")
    _hold_launches("eval", r1["launches"], per_batch, EVAL_ROWS)
    log(f"[eval] B={EVAL_BS}: {r8['wall'] * 1e3 / n_batches:.1f} ms per batch; B=1: "
        f"{r1['wall'] * 1e3 / EVAL_ROWS:.1f} ms per row")
    turns = {}
    if parent is not None:
        with parent_kernels(parent):
            turns["parent"] = _run_eval("eval-parent", root, base / "p8parent", "--eval_batch_size", str(EVAL_BS))
        turns["change"] = _run_eval("eval", root, base / "p8again", "--eval_batch_size", str(EVAL_BS))
        for r in turns.values():
            _hold_launches("eval", r["launches"], per_batch, n_batches)
        log(f"[eval] B={EVAL_BS} rows/s, change / parent / change: {EVAL_ROWS / r8['wall']:.3f} / "
            f"{EVAL_ROWS / turns['parent']['wall']:.3f} / {EVAL_ROWS / turns['change']['wall']:.3f}")
    csv8, csv1 = pd.read_csv(r8["path"]), pd.read_csv(r1["path"])
    if len(csv8) != EVAL_ROWS or list(csv8["Question_Id"]) != list(csv1["Question_Id"]):
        raise AssertionError(f"B={EVAL_BS} rows {list(csv8['Question_Id'])} are not B=1's")

    model = common.init_or_load_params(cfg, None, seed=0, attn_impl="flash", device=dev, dtype=torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    next8, next1 = (_eval_next_logits(model, cfg, root, bs) for bs in (EVAL_BS, 1))
    log(f"[eval] prefill logits at B={EVAL_BS} (all positions, [B, S, V]): peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    tol = 0.0
    for i, (a, b) in enumerate(zip(next8, next1)):
        tol = max(tol, KERNEL_TOL * max(1.0, b.abs().max().item()))
        _hold(f"eval row {i} next-token logits B={EVAL_BS} vs B=1",
              [("logits", a, b, KERNEL_TOL * max(1.0, b.abs().max().item()))])
    same = 0
    for i, (a, b) in enumerate(zip(r8["rows"], r1["rows"])):
        if a["tokens"] == b["tokens"]:
            same += 1
            continue
        t = next(j for j, (x, y) in enumerate(zip(a["tokens"], b["tokens"])) if x != y)
        margin = b["margins"][t]
        log(f"[eval] row {i}: tokens differ first at step {t} ({a['tokens'][t]} at B={EVAL_BS}, "
            f"{b['tokens'][t]} at B=1); B=1 top-2 margin there {margin:.4e} (threshold {2 * tol:.4e})")
        if not margin <= 2 * tol:
            raise AssertionError(f"row {i}: B={EVAL_BS} and B=1 tokens differ at a margin of {margin}")
    log(f"[eval] generated tokens: {same} of {EVAL_ROWS} rows equal at B={EVAL_BS} and B=1")

    ckpt = CheckpointManager(str(base / "ck")).save(0, 1.0, {"params": model.state_dict(), "opt_state": {},
                                                             "step": 0})
    del model, next8, next1
    torch.cuda.empty_cache()
    restored = _run_eval("eval-ckpt", root, base / "pck", "--eval_batch_size", str(EVAL_BS), "--seed", "1",
                         "--student_ckpt_path", ckpt)
    other = _run_eval("eval-ckpt", root, base / "pseed1", "--eval_batch_size", str(EVAL_BS), "--seed", "1")
    csv_ck, csv_other = pd.read_csv(restored["path"]), pd.read_csv(other["path"])
    log(f"[eval-ckpt] restored CSV equals the seed-0 run's: {csv_ck.equals(csv8)}; seed 1 without the "
        f"checkpoint differs: {not csv_other.equals(csv8)}")
    if not csv_ck.equals(csv8) or csv_other.equals(csv8):
        raise AssertionError("the checkpoint restore did not give the seed-0 model's predictions, or its "
                             "negative control did")

    r8q = _run_eval("eval8", root, base / "pq", "--eval_batch_size", str(EVAL_BS), "--quant", "int8_full")
    lm_proj, v_proj = 7 * txt, 6 * vis
    _hold_launches("eval8", r8q["launches"],
                   {**per_batch, "int8_mm": lm_proj + v_proj + (N_NEW - 1) * lm_proj}, n_batches)

    r7 = _run_eval("eval7b", root, base / "p7b", "--eval_batch_size", str(EVAL_7B_BS), "--subset_percentage",
                   str(EVAL_7B_ROWS), "--model_id", "llava-hf/llava-onevision-qwen2-7b-ov-hf")
    n7 = len(r7["rows"])
    _hold_launches("eval7b", r7["launches"], {"flash_fwd_mha": tcfg.vision.num_hidden_layers,
                                              "flash_fwd_gqa_d128": tcfg.text.num_hidden_layers},
                   -(-n7 // EVAL_7B_BS))

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        get_all_results.main(["--predictions_dir", str(base / "p8"), "--metric_backend", "hashed"])
    summary = pd.read_csv(base / "p8" / "summary" / "results_summary.csv")
    log(f"[eval] get_all_results: {summary[['Simple_Accuracy', 'Neural_Similarity', 'File']].to_dict('records')}")
    if not {"Simple_Accuracy", "Neural_Similarity"} <= set(summary.columns) or len(summary) != 1:
        raise AssertionError(f"get_all_results summary {summary}")
    # [mesh] (c) holds the evaluator under a one-rank mesh to these two runs
    plain = {quant: dict(csv=open(r["path"], "rb").read(), tokens=[row["tokens"] for row in r["rows"]],
                         launches=r["launches"], wall=r["wall"], peak=r["peak"])
             for quant, r in (("none", r8), ("int8_full", r8q))}
    shutil.rmtree(base, ignore_errors=True)
    paths = dict(b8=r8, b1=r1, ckpt=restored, seed1=other, int8=r8q, b7=r7)
    return dict(launches={k: sum(r["launches"][k] for r in paths.values()) for k in COUNTERS},
                rows_s8=EVAL_ROWS / r8["wall"], rows_s1=EVAL_ROWS / r1["wall"], peak=r8["peak"],
                host8=r8["host_s"], gen8=r8["generate_s"],
                rows_s8_parent=EVAL_ROWS / turns["parent"]["wall"] if turns else None, plain=plain)


# [create]: cli/create_dataset.py with the student color backend on a
# synthetic SUNRGBD toolbox tree, then the researcher's workflow on the
# dataset it created.  Frames cycle through [eval]'s four sensor sizes;
# six validation frames give each of the six question types one frame's
# rows in the val merge.
CREATE_SPLITS = (("train", 8, 31), ("validation", 6, 32))  # (split, frames, seed)
CREATE_OBJECTS = ("chair", "table", "lamp", "bed", "sofa", "desk", "pillow", "box", "cabinet", "monitor")
CREATE_STUDENT_SEED = 3  # the checkpoint's weights; the runner builds seed 0 before restoring
CREATE_LOGIT_QUESTIONS = 2
CREATE_EVAL_BS = 8


def _create_tree(root, splits) -> dict:
    """The SUNRGBD toolbox layout that ``create_dataset`` reads
    (``splits_output_paths/<split>/{all_rgb,all_depth,annotations}.txt``,
    RGB PNGs, uint16 depth PNGs, annotation JSONs of named objects with
    polygons, one a wall), seeded.  Returns each split's annotations."""
    import numpy as np
    from PIL import Image

    img = root / "SUNRGBD" / "img"
    img.mkdir(parents=True, exist_ok=True)
    anns = {}
    for split, n, seed in splits:
        rng = np.random.default_rng(seed)
        lists = {"all_rgb.txt": [], "all_depth.txt": [], "annotations.txt": []}
        anns[split] = []
        for i in range(n):
            h, w = EVAL_SIZES[i % len(EVAL_SIZES)]
            names = ["wall", *rng.choice(CREATE_OBJECTS, size=4, replace=False).tolist()]
            polys = [{"object": 0, "x": [0, 0, w - 1, w - 1], "y": [0, h // 3, h // 3, 0]}]
            for j in range(1, len(names)):
                x0, y0 = int(rng.integers(0, w // 2)), int(rng.integers(h // 3, h // 2))
                bw, bh = int(rng.integers(20, w // 2)), int(rng.integers(20, h // 2))
                polys.append({"object": j, "x": [x0, x0, x0 + bw, x0 + bw], "y": [y0, y0 + bh, y0 + bh, y0]})
            ann = {"objects": [{"name": nm} for nm in names], "frames": [{"polygon": polys}]}
            paths = [f"SUNRGBD/img/{split}_{kind}_{i}.{ext}" for kind, ext in (("rgb", "png"), ("d", "png"),
                                                                                ("ann", "json"))]
            Image.fromarray(rng.integers(0, 255, size=(h, w, 3)).astype(np.uint8)).save(root / paths[0])
            Image.fromarray(rng.integers(0, 65535, size=(h, w)).astype(np.uint16)).save(root / paths[1])
            (root / paths[2]).write_text(json.dumps(ann))
            for k, p in zip(lists, paths):
                lists[k].append(p)
            anns[split].append(ann)
        d = root / "splits_output_paths" / split
        d.mkdir(parents=True, exist_ok=True)
        for k, v in lists.items():
            (d / k).write_text("\n".join(v))
    return anns


def create_phase(dev) -> dict:
    """[create]: ``cli/create_dataset.py --color_backend student`` on the card
    with a checkpoint of the seeded 0.5B student (full width and depth) on
    the tree of ``_create_tree``, split by split: 0 errors, a Color row for
    every frame with a prominent object, exact launch counts over the color
    questions (K1 26 and K3 24 a question, no other kernel); each question's
    generated tokens bit-equal to those of the same ``Generator`` called
    directly on the same collated batch, and for two of them the prefill
    next-token logits on the kernel path held to the plain path by [main]'s
    cosine; a color backend that raises must fail the CLI (the negative
    control).  Then the workflow on the created dataset, full width and
    depth, the hash tokenizer: ``dataset_statistics`` on the val CSV,
    ``train_online_kd --real_model`` double_trouble phases 1 -> 2 -> 3 (one
    epoch, B=1, A=2, the frozen bf16 7B teacher, each later phase from the
    previous best checkpoint), ``evaluate_onevision`` with the phase-3 best
    at B=8, and ``get_all_results``: finite losses, each phase's checkpoint,
    one prediction per val row, the summary row; each step's wall seconds and
    peak memory.  Data and checkpoints go to build/chip_smoke_create/,
    removed after."""
    import re
    import shutil

    import pandas as pd

    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli import (
        create_dataset,
        dataset_statistics,
        evaluate_onevision,
        get_all_results,
        train_online_kd,
    )
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.data.creation.prominent import (
        find_most_prominent_object,
    )
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.eval import runner
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.train.checkpoint import (
        CheckpointManager,
        find_best_checkpoint,
    )

    t_create = time.perf_counter()
    cfg = llava_onevision_0_5b()
    base = _build.BUILD_DIR.parent / "chip_smoke_create"
    shutil.rmtree(base, ignore_errors=True)
    root = base / "data"
    anns = _create_tree(root, CREATE_SPLITS)
    student = common.init_or_load_params(cfg, None, seed=CREATE_STUDENT_SEED, attn_impl="flash", device=dev,
                                         dtype=torch.bfloat16)
    ckdir = base / "student"
    CheckpointManager(str(ckdir)).save(0, 1.0, {"params": student.state_dict(), "opt_state": {}, "step": 0})
    del student
    torch.cuda.empty_cache()
    log(f"[create] tree ({', '.join(f'{s}: {n} frames' for s, n, _ in CREATE_SPLITS)}; frames cycle through "
        f"{EVAL_SIZES}) and the seed-{CREATE_STUDENT_SEED} 0.5B checkpoint written in "
        f"{time.perf_counter() - t_create:.1f} s")
    argv = ["--root_data_dir", str(root), "--color_backend", "student", "--student_checkpoint", str(ckdir)]
    load = runner.load_student_for_eval

    # the negative control first, on the untouched tree: nothing is written
    def broken_backend(*a, **k):
        def answer(image, question):
            raise RuntimeError("injected color backend fault")
        return answer

    runner.load_student_for_eval = broken_backend
    try:
        create_dataset.main([*argv, "--splits", "validation"])
    except create_dataset.ColorBackendError as e:
        log(f"[create] negative control: a color backend that raises fails the CLI: {e!r}")
    else:
        raise AssertionError("a raising color backend did not fail create_dataset")
    finally:
        runner.load_student_for_eval = load
    if (root / "SUNRGBD" / "csv_data" / "val_dataset.csv").exists():
        raise AssertionError("the failed create_dataset run wrote a val CSV")

    # the run itself: record each color question's batch and tokens
    records = []

    def recording_load(*a, **k):
        answer = load(*a, **k)
        ans = answer.__self__
        generate = ans.gen.generate

        def recorded(model, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = generate(model, batch)
            torch.cuda.synchronize()
            records.append(dict(ans=ans, batch=batch, tokens=out["tokens"].clone(), s=time.perf_counter() - t0))
            return out

        ans.gen.generate = recorded
        return answer

    vis, txt = cfg.vision.num_hidden_layers, cfg.text.num_hidden_layers
    launches = dict.fromkeys(COUNTERS, 0)
    runner.load_student_for_eval = recording_load
    try:
        for split, n, _ in CREATE_SPLITS:
            first = len(records)
            r = _run_cli("create", create_dataset, [*argv, "--splits", split])
            qs = records[first:]
            errors = re.findall(rf"^{split}: \d+ rows, (\d+) errors$", r["log"], re.M)
            color = pd.read_csv(root / "SUNRGBD" / "csv_data" / "individual_datasets" / split / "color.csv")
            prominent = sum(find_most_prominent_object(a) is not None for a in anns[split])
            gen_s = sum(q["s"] for q in qs)
            log(f"[create] {split}: {r['log'].strip().splitlines()}; {len(qs)} color questions, {len(color)} Color "
                f"rows, {prominent} of {n} frames with a prominent object; {r['wall']:.1f} s for the split "
                f"(the student's build and restore included), generate {gen_s:.2f} s "
                f"({len(qs) / gen_s:.3f} color questions/s)")
            if errors != ["0"] or len(color) != prominent or len(qs) != prominent or prominent == 0:
                raise AssertionError(f"[create] {split}: errors {errors}, {len(color)} Color rows and {len(qs)} "
                                     f"questions for {prominent} frames with a prominent object")
            _hold_launches("create", r["launches"], {"flash_fwd_mha": vis, "flash_fwd_gqa": txt}, len(qs))
            for k, v in r["launches"].items():
                launches[k] += v
    finally:
        runner.load_student_for_eval = load

    # each question's tokens against the same Generator called directly
    for i, q in enumerate(records):
        direct = Generator(cfg, q["ans"].gen.gcfg).generate(q["ans"].model, q["batch"])["tokens"]
        if not torch.equal(direct, q["tokens"]):
            raise AssertionError(f"[create] question {i}: the runner's tokens {q['tokens'].tolist()} are not the "
                                 f"direct Generator's {direct.tolist()}")
    log(f"[create] tokens of all {len(records)} color questions bit-equal to the direct Generator's")
    for i, q in enumerate(records[:CREATE_LOGIT_QUESTIONS]):
        model, gen = q["ans"].model, q["ans"].gen
        with torch.no_grad():
            logits, _, lengths = gen.prefill(model, q["batch"])
            last = int(lengths[0]) - 1
            flash_next = logits[0, last].float()
            del logits
            set_attn_impl(model, "xla")
            logits, _, _ = gen.prefill(model, q["batch"])
            plain_next = logits[0, last].float()
            del logits
            set_attn_impl(model, "flash")
        cos = _cosine(flash_next, plain_next)
        log(f"[create] question {i} ({int(lengths[0])} prompt tokens) next-token logits, flash vs plain path: "
            f"max_abs_diff={(flash_next - plain_next).abs().max().item():.4e} (max |logit| "
            f"{plain_next.abs().max().item():.3f}), cosine={cos:.6f}")
        if not (cos >= PATH_COSINE) or not bool(torch.isfinite(flash_next).all()):
            raise AssertionError(f"[create] question {i}: kernel path and plain path disagree (cosine {cos})")
    del records
    torch.cuda.empty_cache()

    # the workflow on the created dataset
    csv_dir = root / "SUNRGBD" / "csv_data"
    val = pd.read_csv(csv_dir / "val_dataset.csv")
    n_train = len(pd.read_csv(csv_dir / "train_dataset.csv"))
    r = _run_cli("create", dataset_statistics, ["--root_data_dir", str(root)])
    if f"val: {len(val)} rows" not in r["log"]:
        raise AssertionError(f"dataset_statistics: {r['log'][-1000:]}")
    log(f"[create] dataset_statistics: {r['log'].strip().splitlines()[0]}")
    ck, best = base / "ck", None
    for phase in (1, 2, 3):
        r = _run_cli(f"create-kd{phase}", train_online_kd, [
            "--real_model", "--root_data_dir", str(root), "--phase", str(phase), "--batch_size", "1",
            "--accumulate_grad_batches", "2", "--max_epochs", "1", "--num_workers", "1",
            "--checkpoint_dir", str(ck), "--tensorboard_dir", str(base / "tb")])
        losses = [float(v) for v in re.findall(r"step \d+ loss (\S+)", r["log"])]
        val_loss = [float(v) for v in re.findall(r"val_loss (\S+)", r["log"])]
        handed = f"phase hand-off: initialized from {best}" in r["log"]
        prev, best = best, find_best_checkpoint(str(ck / f"kd_double_trouble_phase{phase}"))
        log(f"[create] phase {phase} on {n_train} train rows: losses {losses}, val_loss {val_loss}, hand-off from "
            f"the previous phase {handed}, best checkpoint {best and os.path.basename(best)}")
        if (not losses or len(val_loss) != 1 or not all(math.isfinite(v) for v in losses + val_loss)
                or best is None or handed != (phase > 1)):
            raise AssertionError(f"[create] phase {phase}: {r['log'][-2000:]}")
        for k, v in r["launches"].items():
            launches[k] += v
        if prev is not None:  # phase N - 1's checkpoint has been handed off
            shutil.rmtree(os.path.dirname(prev))
    preds = base / "preds"
    r = _run_cli("create", evaluate_onevision, [
        "--root_data_dir", str(root), "--student_ckpt_path", best, "--predictions_dir", str(preds),
        "--eval_batch_size", str(CREATE_EVAL_BS), "--max_new_tokens", str(N_NEW), "--metric_backend", "hashed"])
    _hold_launches("create-eval", r["launches"], {"flash_fwd_mha": vis, "flash_fwd_gqa": txt},
                   -(-len(val) // CREATE_EVAL_BS))
    for k, v in r["launches"].items():
        launches[k] += v
    pred = pd.read_csv(r["ret"]["path"])
    if list(pred["Question_Id"]) != list(val["Question_Id"]) or len(pred) != len(val):
        raise AssertionError(f"[create] predictions for {list(pred['Question_Id'])}, val rows "
                             f"{list(val['Question_Id'])}")
    os.remove(preds / "summary" / "results_summary.csv")  # get_all_results writes it anew
    _run_cli("create", get_all_results, ["--predictions_dir", str(preds), "--metric_backend", "hashed"])
    summary = pd.read_csv(preds / "summary" / "results_summary.csv")
    if list(summary["File"]) != [os.path.basename(r["ret"]["path"])]:
        raise AssertionError(f"[create] summary {summary.to_dict('records')}")
    log(f"[create] {len(pred)} predictions, one a val row; summary "
        f"{summary[['Simple_Accuracy', 'Neural_Similarity', 'File']].to_dict('records')}")
    shutil.rmtree(base, ignore_errors=True)
    secs = time.perf_counter() - t_create
    log(f"[create] total {secs:.1f} s")
    return dict(launches=launches, seconds=secs)


def main_path_phase(dev, tag: str = "main") -> dict:
    """Serving: greedy generation with the 0.5B student, full width and depth."""
    cfg = llava_onevision_0_5b()
    t0 = time.perf_counter()
    model = common.init_or_load_params(cfg, None, seed=0, attn_impl="flash",
                                       device=dev, dtype=torch.bfloat16)
    batch = synthetic_kd_batch(cfg, 1, seq_len=3072, orig_sizes=[(530, 730)], seed=3)
    keys = ("student_input_ids", "student_attention_mask", "student_pixel_values",
            "pack_idx", "pack_weight", "pack_valid", "tile_valid")
    tb = {k: torch.as_tensor(batch[k], device=dev) for k in keys}
    gen = Generator(cfg, GenerateConfig(max_new_tokens=N_NEW, eos_token_id=-1))
    torch.cuda.synchronize()
    log(f"[{tag}] model + batch set-up {time.perf_counter() - t0:.1f} s; "
        f"prompt {int(tb['student_attention_mask'].sum())} tokens in a {tb['student_input_ids'].shape[1]} bucket")

    gen.generate(model, tb)  # warm-up (allocator, cuBLAS handles)
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    outs = [gen.generate(model, tb) for _ in range(GEN_CALLS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    want = dict.fromkeys(COUNTERS, 0)
    want.update(flash_fwd_mha=cfg.vision.num_hidden_layers * GEN_CALLS,
                flash_fwd_gqa=cfg.text.num_hidden_layers * GEN_CALLS)
    log(f"[{tag}] launches over {GEN_CALLS} generate calls: {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")

    ms_call = wall * 1e3 / GEN_CALLS
    tok_s = N_NEW * tb["student_input_ids"].shape[0] / (wall / GEN_CALLS)
    log(f"[{tag}] generate: {ms_call:.1f} ms/call, {tok_s:.1f} tok/s "
        f"(B=1, {N_NEW} new tokens, bf16)")

    toks = outs[-1]["tokens"]
    if toks.shape != (1, N_NEW):
        raise AssertionError(f"tokens shape {tuple(toks.shape)}")
    if not ((toks >= 0) & (toks < cfg.text.vocab_size)).all():
        raise AssertionError("token out of the vocab")
    if not all(torch.equal(o["tokens"], toks) for o in outs):
        raise AssertionError("repeated generate calls disagree")

    # Prefill logits: finite, and the kernel path agrees with the plain path
    # (same weights, attention through flash_attention_ref-equivalent math).
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _, lengths = gen.prefill(model, tb)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        last = int(lengths[0]) - 1
        flash_next = logits[0, last].float()
        finite = bool(torch.isfinite(logits).all())
        shape = tuple(logits.shape)
        del logits
        set_attn_impl(model, "xla")
        logits, _, _ = gen.prefill(model, tb)
        plain_next = logits[0, last].float()
        del logits
        set_attn_impl(model, "flash")
    if shape != (1, 3072, cfg.text.vocab_size) or not finite:
        raise AssertionError(f"prefill logits shape {shape}, finite={finite}")
    diff = (flash_next - plain_next).abs().max().item()
    scale = plain_next.abs().max().item()
    cos = _cosine(flash_next, plain_next)
    same_argmax = int(flash_next.argmax()) == int(plain_next.argmax())
    log(f"[{tag}] prefill {prefill_ms:.1f} ms; decode {(ms_call - prefill_ms) / (N_NEW - 1):.2f} ms/step "
        f"(from the generate time)")
    log(f"[{tag}] next-token logits, flash vs plain path: max_abs_diff={diff:.4e} "
        f"(max |logit| {scale:.3f}), cosine={cos:.6f}, same argmax={same_argmax}")
    if not (cos >= PATH_COSINE):
        raise AssertionError(f"kernel path and plain path disagree (cosine {cos})")
    return dict(launches=launches, ms_call=ms_call, tok_s=tok_s)


def main8_phase(dev) -> dict:
    """Serving int8 ([main8]): the 0.5B student of the serving phase
    quantized int8_full in place (``cli/inference.py --quant int8_full``:
    its 24 x 7 decoder and 26 x 6 SigLIP projections become QLinear, the
    tied embedding and head stay bf16), greedy generation with exact launch
    counts (K12 in the prefill and in every decode step, SigLIP's only in
    the prefill), and the prefill's next-token logits on the kernel path
    against the plain path; their cosine to the bf16 model's is printed,
    not held (the weights are random)."""
    cfg = llava_onevision_0_5b()
    t0 = time.perf_counter()
    model = common.init_or_load_params(cfg, None, seed=0, attn_impl="flash", device=dev, dtype=torch.bfloat16)
    batch = synthetic_kd_batch(cfg, 1, seq_len=3072, orig_sizes=[(530, 730)], seed=3)
    keys = ("student_input_ids", "student_attention_mask", "student_pixel_values",
            "pack_idx", "pack_weight", "pack_valid", "tile_valid")
    tb = {k: torch.as_tensor(batch[k], device=dev) for k in keys}
    gen = Generator(cfg, GenerateConfig(max_new_tokens=N_NEW, eos_token_id=-1))
    with torch.no_grad():
        logits, _, lengths = gen.prefill(model, tb)
        last = int(lengths[0]) - 1
        bf16_next = logits[0, last].float()
        del logits
    i8.quantize_model_int8(model, include_vision=True)
    torch.cuda.synchronize()
    lm_proj, v_proj = 7 * cfg.text.num_hidden_layers, 6 * cfg.vision.num_hidden_layers
    n_q = sum(isinstance(m, qwen2.QLinear) for m in model.modules())
    if n_q != lm_proj + v_proj:
        raise AssertionError(f"{n_q} QLinear modules, expected {lm_proj + v_proj}")
    log(f"[main8] model + batch set-up and int8_full quantization {time.perf_counter() - t0:.1f} s; "
        f"{n_q} projections int8")

    gen.generate(model, tb)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    outs = [gen.generate(model, tb) for _ in range(GEN_CALLS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    want = dict.fromkeys(COUNTERS, 0)
    want.update(flash_fwd_mha=cfg.vision.num_hidden_layers * GEN_CALLS,
                flash_fwd_gqa=cfg.text.num_hidden_layers * GEN_CALLS,
                int8_mm=(lm_proj + v_proj + (N_NEW - 1) * lm_proj) * GEN_CALLS)
    log(f"[main8] launches over {GEN_CALLS} generate calls: {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"int8 serving launch counts {launches} != {want}")
    ms_call = wall * 1e3 / GEN_CALLS
    tok_s = N_NEW / (wall / GEN_CALLS)
    log(f"[main8] generate: {ms_call:.1f} ms/call, {tok_s:.1f} tok/s (B=1, {N_NEW} new tokens, int8_full)")
    toks = outs[-1]["tokens"]
    if toks.shape != (1, N_NEW) or not ((toks >= 0) & (toks < cfg.text.vocab_size)).all():
        raise AssertionError(f"int8 tokens {toks}")
    if not all(torch.equal(o["tokens"], toks) for o in outs):
        raise AssertionError("repeated int8 generate calls disagree")

    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _, _ = gen.prefill(model, tb)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        kernel_next = logits[0, last].float()
        finite = bool(torch.isfinite(logits).all())
        del logits
        set_attn_impl(model, "xla")
        with plain_int8():
            logits, _, _ = gen.prefill(model, tb)
        plain_next = logits[0, last].float()
        del logits
    del model
    torch.cuda.empty_cache()
    if not finite:
        raise AssertionError("non-finite int8 prefill logits")
    cos = _cosine(kernel_next, plain_next)
    log(f"[main8] prefill {prefill_ms:.1f} ms; next-token logits, kernel vs plain path: max_abs_diff="
        f"{(kernel_next - plain_next).abs().max().item():.4e}, cosine={cos:.6f} (tol {PATH_COSINE}); "
        f"int8 vs bf16 model cosine {_cosine(kernel_next, bf16_next):.6f} (not held: random weights)")
    if not (cos >= PATH_COSINE):
        raise AssertionError(f"int8 kernel path and plain path disagree (cosine {cos})")
    return dict(launches=launches, ms_call=ms_call, tok_s=tok_s)


def _param_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def kd8_phase(dev, teacher) -> dict:
    """[kd8]: the shared bf16 teacher quantized in place into the benchmark's
    configuration (int8_full, the int8 embedding and the vocab-major int8
    head), its logits per micro-batch timed before and after (CUDA events),
    then 6 phase-3 steps: K12 in all 28 x 7 + 26 x 6 teacher projections
    and K10 once per micro-batch, beside the phase-3 kernels."""
    scfg, tcfg = llava_onevision_0_5b(), llava_onevision_7b()
    temp = kd_loss_config_for("double_trouble").temperature
    batch = synthetic_kd_batch(scfg, 1, seq_len=3072, orig_sizes=[(530, 730)], seed=3)
    tb = _device_batch(batch, dev, streams=("student_", "teacher_"))

    def teacher_ms():
        return time_ms(lambda: kd_step._teacher_logits(teacher, tb, scfg.text.vocab_size, temp), iters=3,
                       warmup=1)

    bf16_ms, bf16_bytes = teacher_ms(), _param_bytes(teacher)
    t0 = time.perf_counter()
    i8.quantize_model_int8(teacher, include_vision=True, include_embed_head=True)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    int8_ms, int8_bytes = teacher_ms(), _param_bytes(teacher)
    del tb
    torch.cuda.empty_cache()
    log(f"[kd8] teacher quantized in place in {quant_s:.1f} s: weights {bf16_bytes / 1e9:.2f} GB bf16 -> "
        f"{int8_bytes / 1e9:.2f} GB; teacher forward + logits per micro-batch {bf16_ms:.1f} ms bf16 -> "
        f"{int8_ms:.1f} ms int8 (CUDA events)")
    r = kd8_steps(dev, teacher)
    r.update(teacher_ms=int8_ms, teacher_ms_bf16=bf16_ms)
    return r


def kd8_steps(dev, teacher, tag: str = "kd8") -> dict:
    """6 phase-3 steps against the teacher quantized by :func:`kd8_phase`."""
    tcfg = llava_onevision_7b()
    n_proj = 7 * tcfg.text.num_hidden_layers + 6 * tcfg.vision.num_hidden_layers
    return kd_path(dev, teacher, tag, "double_trouble", 3, KD_STEPS,
                   _kd_per_micro(fused_loca_ce_fwd=1, fused_loca_ce_bwd=1, int8_mm=n_proj, tmat_int8=1))


# [remat]: the student's remat settings on the phase-3 KD step, each on a
# fresh student from the same seed: (label, LlavaOnevision kwargs).
REMAT_SETTINGS = (("off", {}), ("full", dict(remat=True)), ("dots", dict(remat=True, remat_policy="dots")),
                  ("flash", dict(remat=True, remat_policy="flash")),
                  ("full+mlp_chunk", dict(remat=True, mlp_chunk=512)))
REMAT_STEPS = 4
REMAT_B2_STEPS = 3


def _fresh_student(dev, cfg, dtype=torch.bfloat16, attn_impl="flash", **remat):
    """The 0.5B student (seed 0) with the given remat kwargs, trainable."""
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.models import (
        LlavaOnevision,
        init_weights,
    )

    model = LlavaOnevision(cfg, attn_impl=attn_impl, device=dev, dtype=dtype, **remat)
    init_weights(model, 0)
    return model.requires_grad_(True).train()


def _profiled_ms(fn) -> float:
    """Device kernel time of one call of ``fn`` by torch.profiler (kernels
    only, not the device ranges of annotations; CUDA activity alone, which
    costs the host far less than tracing its ops too)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() / 1e3 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False))


def _remat_steps(dev, teacher, student, tb, steps, tag):
    """``steps`` phase-3 steps, then one more under torch.profiler: (losses,
    host ms a step (the mean after the first ``KD_WARMUP``), device ms of
    the profiled step, peak bytes, launches of the unprofiled steps)."""
    cfg = TrainConfig(kd_mode="double_trouble", phase=3, loss=kd_loss_config_for("double_trouble"),
                      accumulate_grad_batches=tb["labels"].shape[0], learning_rate=KD_LR, cosine_t_max=0,
                      ce_impl="fused")
    box = [TrainState(student, make_optimizer(student, KD_LR, kd_mode="double_trouble", phase=3))]
    step = make_train_step(KDModels(student, teacher), cfg)
    losses, times = [], []
    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        box[0], metrics = step(box[0], None, tb)
        losses.append(metrics["loss"].item())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)

    def one():
        box[0], m = step(box[0], None, tb)
        losses.append(m["loss"].item())

    device_ms = _profiled_ms(one)
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"[{tag}] loss not finite and falling: {losses}")
    del box, step
    timed = times[KD_WARMUP:]
    return losses, sum(timed) / len(timed), device_ms, peak, launches


def _leaf_errors(names, got, want) -> float:
    """The worst relative Frobenius error over gradient leaves.  A leaf that
    is zero in both is equal; SigLIP's key-projection bias, whose gradient
    is zero in exact arithmetic (a vector added to every key shifts each
    query's scores by a constant) and rounding alone here, is measured
    against its layer's key-projection weight gradient (the same dk rows,
    summed against the inputs) instead of against itself."""
    by_name = dict(zip(names, want))
    worst = 0.0
    for name, a, b in zip(names, got, want):
        if a is None and b is None:
            continue
        a, b = a.float(), b.float()
        scale = b.norm()
        if name.startswith("vision_tower.") and name.endswith("self_attn.k_proj.bias"):
            scale = by_name[name[:-len("bias")] + "weight"].float().norm()
        err = (a - b).norm()
        if err == 0:
            continue
        worst = max(worst, (err / scale).item() if scale > 0 else float("inf"))
    return worst


def remat_phase(dev, teacher) -> dict:
    """[remat]: the double-trouble phase-3 KD step (A=2 x B=1, the frozen
    bf16 7B teacher, the 0.5B student at full width and depth, the SUNRGBD
    frame in its 3072 bucket) with the student's remat off, ``full``,
    ``dots``, ``flash`` and ``full`` with ``mlp_chunk=512``, each on a fresh
    student from the same seed and the same batch: the loss and every
    gradient leaf of one micro-batch against remat off (whether bit-equal,
    and the relative Frobenius bound), exact launch counts (the student's
    flash forwards twice under full and dots, once under flash), step ms
    (host clock), device ms (one profiled step) and peak memory.  Then B=2,
    the KD default of ``bench.py`` (A=1), with ``full`` and ``mlp_chunk``
    and without remat: peak memory, samples/s, a finite and falling loss.
    Then ``xla_chunked`` against ``xla`` at 2+2 layers on the plain path."""
    scfg = llava_onevision_0_5b()
    batch = synthetic_kd_batch(scfg, 1, seq_len=3072, orig_sizes=[(530, 730)], accum=ACCUM, seed=3)
    tb = _device_batch(batch, dev, streams=("student_", "teacher_"))
    micro = {k: v[0] for k, v in tb.items()}
    cfg = TrainConfig(kd_mode="double_trouble", phase=3, loss=kd_loss_config_for("double_trouble"), ce_impl="fused")
    v, t = scfg.vision.num_hidden_layers, scfg.text.num_hidden_layers
    launches = dict.fromkeys(COUNTERS, 0)
    ref, out = None, {}
    for label, kw in REMAT_SETTINGS:
        student = _fresh_student(dev, scfg, **kw)
        loss_fn = make_loss_fn(KDModels(student, teacher), cfg)
        names, leaves = zip(*student.named_parameters())
        reset_counts()
        loss, _ = loss_fn(micro)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
        got = read_counts()
        twice = kw.get("remat") and kw.get("remat_policy", "full") != "flash"
        want = dict.fromkeys(COUNTERS, 0)
        want.update(_kd_per_micro(fused_loca_ce_fwd=1, fused_loca_ce_bwd=1))
        if twice:
            want["flash_fwd_mha"] += v
            want["flash_fwd_gqa"] += t
        if got != want:
            raise AssertionError(f"[remat] {label}: launches on one micro-batch {got} != {want}")
        if ref is None:
            ref = (loss.detach(), grads)
            agree = "the reference"
        else:
            bit = loss.item() == ref[0].item() and all(torch.equal(a, b) for a, b in zip(grads, ref[1]))
            rel = _leaf_errors(names, grads, ref[1])
            lrel = abs(loss.item() - ref[0].item()) / abs(ref[0].item())
            agree = (f"loss {loss.item():.6f} vs {ref[0].item():.6f} (rel {lrel:.2e}), worst leaf relative "
                     f"Frobenius {rel:.2e}; bit-equal {bit}")
            if lrel > LOSS_REL_TOL or rel > REL_FRO_TOL:
                raise AssertionError(f"[remat] {label} disagrees with remat off: {agree}")
        del loss, grads
        losses, step_ms, device_ms, peak, step_launches = _remat_steps(dev, teacher, student, tb, REMAT_STEPS,
                                                                       f"remat {label}")
        want_steps = {k: n * ACCUM * REMAT_STEPS for k, n in want.items()}
        if step_launches != want_steps:
            raise AssertionError(f"[remat] {label}: launches over {REMAT_STEPS} steps {step_launches} != {want_steps}")
        for k in launches:
            launches[k] += step_launches[k]
        flash_fwd = (step_launches["flash_fwd_mha"] // REMAT_STEPS, step_launches["flash_fwd_gqa"] // REMAT_STEPS)
        log(f"[remat] {label}: {agree}; a step: K1 {flash_fwd[0]}, K3 {flash_fwd[1]} (with lse), exact; step "
            f"{step_ms:.1f} ms (host, mean of steps {KD_WARMUP + 1}-{REMAT_STEPS}), device {device_ms:.1f} ms (one profiled "
            f"step), {ACCUM / (step_ms / 1e3):.3f} samples/s; peak {peak / 2**30:.2f} GiB; losses "
            f"{', '.join(f'{x:.6f}' for x in losses)}")
        out[label] = dict(step_ms=step_ms, device_ms=device_ms, peak=peak)
        del student, loss_fn, names, leaves
        torch.cuda.empty_cache()
    del ref
    torch.cuda.empty_cache()

    b2 = synthetic_kd_batch(scfg, 2, seq_len=3072, orig_sizes=[(530, 730)] * 2, accum=1, seed=4)
    tb2 = _device_batch(b2, dev, streams=("student_", "teacher_"))
    for label, kw in (("B=2 full+mlp_chunk", dict(remat=True, mlp_chunk=512)), ("B=2 off", {})):
        student = _fresh_student(dev, scfg, **kw)
        losses, step_ms, device_ms, peak, step_launches = _remat_steps(dev, teacher, student, tb2, REMAT_B2_STEPS,
                                                                       f"remat {label}")
        for k in launches:
            launches[k] += step_launches[k]
        log(f"[remat] {label} (A=1, bench.py's KD default): step {step_ms:.1f} ms (host), device "
            f"{device_ms:.1f} ms, {2 / (step_ms / 1e3):.3f} samples/s; peak {peak / 2**30:.2f} GiB; losses "
            f"{', '.join(f'{x:.6f}' for x in losses)}")
        out[label] = dict(step_ms=step_ms, device_ms=device_ms, peak=peak)
        del student
        torch.cuda.empty_cache()
    del tb2

    # xla_chunked against xla: the baseline loss and gradients at 2+2 layers, plain path
    cut = _cut(scfg)
    bcfg = TrainConfig(kd_mode="baseline", ce_impl="chunked", loss_chunk_size=256)
    res = {}
    for impl in ("xla", "xla_chunked"):
        student = _fresh_student(dev, cut, attn_impl=impl)
        loss, _ = make_loss_fn(KDModels(student, None), bcfg)(micro)
        names, leaves = zip(*student.named_parameters())
        res[impl] = (loss.item(), torch.autograd.grad(loss, leaves, allow_unused=True))
        del student, loss
    rel = _leaf_errors(names, *(r[1] for r in res.values()))
    lrel = abs(res["xla"][0] - res["xla_chunked"][0]) / abs(res["xla"][0])
    log(f"[remat] xla_chunked vs xla, baseline loss at 2+2 layers: {res['xla_chunked'][0]:.6f} vs "
        f"{res['xla'][0]:.6f} (rel {lrel:.2e}); worst gradient leaf relative Frobenius {rel:.2e}")
    if lrel > LOSS_REL_TOL or rel > REL_FRO_TOL:
        raise AssertionError("[remat] xla_chunked disagrees with xla")
    del res, tb
    torch.cuda.empty_cache()
    return dict(launches=launches, runs=out)


# [mesh] (a): the KD CLI's rows of the synthetic tree (12 rows x 0.34: 4
# train rows, 2 steps of A=2, and 4 validation rows).
MESH_SUBSET = "0.34"
MESH_ROWS_SEED = 23
MESH_LOSS_TOL = 1e-4  # row-sharded sums vs one kernel call: f32 sums regrouped


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


@contextlib.contextmanager
def _one_rank_group():
    """The environment torchrun would set for one rank (a free port), for a
    CLI's ``--distributed`` run; removed after, and the CLI must have left
    its process group."""
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    os.environ.update(env)
    try:
        yield
    finally:
        for k in env:
            os.environ.pop(k, None)
    if torch.distributed.is_initialized():
        raise AssertionError("[mesh] the CLI left its process group up")


def mesh_cli_phase(dev) -> dict:
    """[mesh] (a): the KD CLI (phase 3, the 7B teacher, the 0.5B student at
    full width and depth, remat as the CLI builds them) with
    ``--distributed --mesh 1,1,1`` under a one-rank NCCL group (the
    environment torchrun would set, set here), on 4 train and 4 validation
    rows of the synthetic tree; then the same CLI run without
    ``--distributed`` at the same seed.  The distributed run's student is
    FSDP2-sharded (every parameter a DTensor, its float32 masters the
    sharded parameters), the kernels take local tensors (a DTensor reaching
    a launcher raises), its launch counts are exact (per train micro-batch
    the flash forwards of the student twice, remat; per validation
    micro-batch the forwards and K11's forward), and its train and
    validation losses are held to the plain run's."""
    import re
    import shutil

    from torch.distributed.tensor import DTensor

    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli import train_online_kd
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.train import loop as kd_loop

    root = _build.BUILD_DIR.parent / "chip_smoke_mesh"
    shutil.rmtree(root, ignore_errors=True)
    orig_train, orig_eval = kd_loop.make_train_step, kd_loop.make_eval_step
    v, t = llava_onevision_0_5b().vision.num_hidden_layers, llava_onevision_0_5b().text.num_hidden_layers
    per_train = _kd_per_micro(fused_loca_ce_fwd=1, fused_loca_ce_bwd=1)
    per_train["flash_fwd_mha"] += v
    per_train["flash_fwd_gqa"] += t
    per_val = {"flash_fwd_mha": 2 * v, "flash_fwd_gqa": t,
               "flash_fwd_gqa_d128": llava_onevision_7b().text.num_hidden_layers, "fused_loca_ce_fwd": 1}
    runs, launches = {}, dict.fromkeys(COUNTERS, 0)
    for label in ("distributed", "plain"):
        rec = dict(micro=0, val=[], losses=[], sharded=None)

        def make_train(models, cfg, _rec=rec):
            fn = orig_train(models, cfg)

            def wrapped(state, tp, batch):
                _rec["sharded"] = all(isinstance(p, DTensor) for p in state.model.parameters())
                _rec["micro"] += batch["labels"].shape[0]
                state, m = fn(state, tp, batch)
                _rec["losses"].append(m["loss"].item())
                return state, m

            return wrapped

        def make_eval(models, cfg, _rec=rec):
            fn = orig_eval(models, cfg)

            def wrapped(state, tp, batch):
                m = fn(state, tp, batch)
                _rec["val"].append(m["loss"].item())
                return m

            return wrapped

        d = root / label
        argv = ["--real_model", "--synthetic_data", "--root_data_dir", str(root / "data"), "--phase", "3",
                "--batch_size", "1", "--accumulate_grad_batches", str(ACCUM), "--max_epochs", "1",
                "--num_workers", "1", "--subset_percentage", MESH_SUBSET, "--checkpoint_dir", str(d / "ck"),
                "--tensorboard_dir", str(d / "tb")]
        if label == "distributed":
            argv += ["--distributed", "--mesh", "1,1,1"]
        kd_loop.make_train_step, kd_loop.make_eval_step = make_train, make_eval
        try:
            with _one_rank_group() if label == "distributed" else contextlib.nullcontext():
                r = _run_cli(f"mesh-{label}", train_online_kd, argv)
        finally:
            kd_loop.make_train_step, kd_loop.make_eval_step = orig_train, orig_eval
        want = {k: per_train.get(k, 0) * rec["micro"] + per_val.get(k, 0) * len(rec["val"]) for k in COUNTERS}
        saved = re.findall(r"saved checkpoint (\S+)", r["log"])
        log(f"[mesh] {label}: {rec['micro']} train and {len(rec['val'])} validation micro-batches, student "
            f"sharded (FSDP2 DTensors): {rec['sharded']}; losses {rec['losses']}, validation {rec['val']}; "
            f"{r['wall']:.1f} s, peak {r['peak'] / 2**30:.2f} GiB; launches exact: {r['launches'] == want}; "
            f"checkpoint {[os.path.basename(x) for x in saved]}")
        if r["launches"] != want:
            raise AssertionError(f"[mesh] {label} launches {r['launches']} != {want}")
        if rec["sharded"] != (label == "distributed") or not rec["losses"] or len(saved) != 1:
            raise AssertionError(f"[mesh] {label}: {r['log'][-2000:]}")
        for k in launches:
            launches[k] += r["launches"][k]
        runs[label] = dict(rec, wall=r["wall"], peak=r["peak"])
    a, b = runs["distributed"], runs["plain"]
    pairs = list(zip(a["losses"] + a["val"], b["losses"] + b["val"]))
    worst = max(abs(x - y) / abs(y) for x, y in pairs)
    log(f"[mesh] --distributed --mesh 1,1,1 vs the plain CLI: {len(pairs)} losses, worst rel diff {worst:.2e}; "
        f"bit-equal {all(x == y for x, y in pairs)}")
    if len(a["losses"]) != len(b["losses"]) or worst > LOSS_REL_TOL:
        raise AssertionError(f"[mesh] the one-rank mesh run disagrees with the plain run: {pairs}")
    shutil.rmtree(root, ignore_errors=True)
    return dict(launches=launches, runs=runs)


MESH_LOSSES = ("K11 LoCa + CE", "K5/K6 CE", "K7/K8 KL", "K9 LoCa")


def _mesh_rows_data(dev):
    g = torch.Generator(device=dev).manual_seed(MESH_ROWS_SEED)
    hs, ws, tmat, lab, lab_ce = _loca_inputs(dev, g, 3072, llava_onevision_0_5b().text.vocab_size, 896)
    return hs, ws, tmat, lab, torch.where(lab_ce < 0, torch.full_like(lab_ce, -100), lab_ce)


def _mesh_rows_loss(name, hs, ws, tmat, lab, lab_ce):
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops import fused_spmd as fs

    lc = kd_loss_config_for("double_trouble")
    kw = dict(temperature=lc.temperature)
    if name == "K11 LoCa + CE":
        loca, ce = fs.fused_loca_ce_loss_spmd(hs, ws, tmat, lab, lab_ce, alpha=lc.loca_alpha, **kw)
        return lc.gamma * (loca + ce) + (1.0 - lc.gamma) * ce
    if name == "K5/K6 CE":
        return fs.fused_ce_loss_spmd(hs, ws, lab_ce, w_layout="vd")
    if name == "K7/K8 KL":
        return fs.fused_kl_loss_spmd(hs, ws, tmat, **kw)
    return fs.fused_loca_loss_spmd(hs, ws, tmat, lab, alpha=lc.loca_alpha, **kw)


def _mesh_rows_worker(rank, world, port, out_dir):
    """One of the ranks of [mesh] (b): a gloo group on the one card, each
    rank on its half of the rows through the ``*_spmd`` wrappers; writes its
    losses, dh and dW, and the K11 loss with its sums left out of the
    all-reduce (the negative control)."""
    import torch.distributed as dist

    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops import fused_spmd as fs
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.parallel import (
        MeshConfig,
        make_mesh,
        use_mesh,
    )

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", rank=rank, world_size=world, init_method=f"tcp://127.0.0.1:{port}")
    try:
        _build.load_library()
        dev = torch.device("cuda", 0)
        mesh = make_mesh(MeshConfig(1, world, 1), "cpu")
        hs, ws, tmat, lab, lab_ce = _mesh_rows_data(dev)
        n = hs.shape[0] // world
        rows = slice(rank * n, (rank + 1) * n)
        out = {}
        reset_counts()
        for name in MESH_LOSSES:
            h = hs[rows].detach().clone().requires_grad_(True)
            w = ws.detach().clone().requires_grad_(True)
            with use_mesh(mesh):
                loss = _mesh_rows_loss(name, h, w, tmat[rows], lab[rows], lab_ce[rows])
            loss.backward()
            out[name] = (loss.item(), h.grad.cpu(), w.grad.cpu())
        launches = read_counts()
        real = fs.all_reduce_sum

        def drop_rank1(t, mesh_, axes=("data", "fsdp")):
            if rank == 1:  # K11's sums (kl, ce), not its counts
                t[:2].zero_()
            return real(t, mesh_, axes)

        fs.all_reduce_sum = drop_rank1
        try:
            with use_mesh(mesh), torch.no_grad():
                dropped = _mesh_rows_loss(MESH_LOSSES[0], hs[rows], ws, tmat[rows], lab[rows], lab_ce[rows]).item()
        finally:
            fs.all_reduce_sum = real
        torch.save(dict(out=out, dropped=dropped, launches=launches), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def mesh_rows_phase(dev) -> dict:
    """[mesh] (b): two processes in a gloo group share the card, each
    running K11 forward and backward, K5/K6, K7/K8 and K9 through the
    ``*_spmd`` wrappers (mesh (1, 2, 1)) on its half of the KD shape's rows
    (N = 3072, the 152k vocab).  The losses of both ranks (the global ones,
    from the all-reduced sums) and each rank's dh, row for row, are held to
    one kernel call on all the rows in this process; the dW of the two
    ranks, summed, to its dW; and a K11 loss with one rank's sums left out
    of the all-reduce must fail the bound."""
    import shutil

    import torch.multiprocessing as mp

    out_dir = _build.BUILD_DIR.parent / "chip_smoke_mesh_rows"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    world = 2
    t0 = time.perf_counter()
    mp.spawn(_mesh_rows_worker, args=(world, _free_port(), str(out_dir)), nprocs=world, join=True)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(world)]
    shutil.rmtree(out_dir, ignore_errors=True)
    hs, ws, tmat, lab, lab_ce = _mesh_rows_data(dev)
    n = hs.shape[0] // world
    for name in MESH_LOSSES:
        h = hs.detach().clone().requires_grad_(True)
        w = ws.detach().clone().requires_grad_(True)
        loss = _mesh_rows_loss(name, h, w, tmat, lab, lab_ce)  # no mesh: one kernel call on every row
        loss.backward()
        want = loss.item()
        got = [r["out"][name][0] for r in ranks]
        rel = max(abs(x - want) / abs(want) for x in got)
        dh = torch.cat([r["out"][name][1] for r in ranks]).to(dev)
        dw = sum(r["out"][name][2].to(dev).float() for r in ranks)
        log(f"[mesh] {name}: two ranks {got[0]:.9e} / {got[1]:.9e}, one call {want:.9e} (rel {rel:.2e}); "
            f"dh bit-equal row for row {torch.equal(dh, h.grad)}")
        if rel > MESH_LOSS_TOL:
            raise AssertionError(f"[mesh] {name}: the ranks' losses {got} disagree with one call's {want}")
        _hold(f"mesh {name} dh (rows of both ranks) and summed dW", [
            ("dh", dh, h.grad, _kd_bound(h.grad)), ("dW", dw, w.grad.float(), _kd_bound(w.grad))])
        if name == MESH_LOSSES[0]:
            bad = max(abs(r["dropped"] - want) / abs(want) for r in ranks)
            log(f"[mesh] negative control, rank 1's LoCa and CE sums left out of K11's all-reduce: loss "
                f"{ranks[0]['dropped']:.6e} vs {want:.6e} (rel {bad:.2e}) must fail the {MESH_LOSS_TOL:.0e} bound")
            if bad <= MESH_LOSS_TOL:
                raise AssertionError("[mesh] the bound does not see a rank's sums left out of the all-reduce")
        del h, w, loss
    per_rank = {k: v for k, v in ranks[0]["launches"].items() if v}
    log(f"[mesh] each rank's launches: {per_rank}; the two processes {spawn_s:.1f} s")
    want = dict(fused_loca_ce_fwd=1, fused_loca_ce_bwd=1, fused_ce_fwd=1, fused_ce_bwd=1, fused_kl_fwd=1,
                fused_kl_bwd=1, fused_kl_bwd_dw=1, fused_loca_fwd=1, fused_loca_bwd=1)
    if any(r["launches"] != {**dict.fromkeys(COUNTERS, 0), **want} for r in ranks):
        raise AssertionError(f"[mesh] rank launches {[r['launches'] for r in ranks]} != {want}")
    del hs, ws, tmat
    torch.cuda.empty_cache()
    return dict(seconds=spawn_s)


def mesh_eval_phase(dev, evals) -> dict:
    """[mesh] (c): the evaluator CLI with ``--distributed --mesh 1,1,1``
    under a one-rank NCCL group, on ``_eval_tree``'s 21 rows at B=8, bf16
    and then ``--quant int8_full``, held to [eval]'s plain runs of the same
    flags: the predictions CSV byte for byte, every row's tokens, and exact
    launch counts (K1/K3 at each prefill; K12 as [eval8]).  The bf16
    student is sharded by ``shard_params`` (every LM parameter a DTensor
    when ``generate`` is called, FSDP2 gathering it for each forward); the
    int8 model stays replicated (no DTensor)."""
    import shutil

    from torch.distributed.tensor import DTensor

    cfg = llava_onevision_0_5b()
    vis, txt = cfg.vision.num_hidden_layers, cfg.text.num_hidden_layers
    per_batch = {"flash_fwd_mha": vis, "flash_fwd_gqa": txt}
    per_quant = {"none": per_batch,
                 "int8_full": {**per_batch, "int8_mm": 7 * txt + 6 * vis + (N_NEW - 1) * 7 * txt}}
    n_batches = -(-EVAL_ROWS // EVAL_BS)
    base = _build.BUILD_DIR.parent / "chip_smoke_mesh_eval"
    shutil.rmtree(base, ignore_errors=True)
    root = _eval_tree(base / "data")
    generate = Generator.generate
    launches, runs = dict.fromkeys(COUNTERS, 0), {}
    for quant in ("none", "int8_full"):
        seen = []

        def recording(self, model, batch, _seen=seen):
            _seen.append(all(isinstance(p, DTensor) for p in model.language_model.parameters()))
            return generate(self, model, batch)

        Generator.generate = recording
        try:
            with _one_rank_group():
                r = _run_eval("mesh-eval", root, base / quant, "--eval_batch_size", str(EVAL_BS), "--quant", quant,
                              "--distributed", "--mesh", "1,1,1")
        finally:
            Generator.generate = generate
        plain = evals["plain"][quant]
        same_csv = open(r["path"], "rb").read() == plain["csv"]
        same_tokens = [row["tokens"] for row in r["rows"]] == plain["tokens"]
        log(f"[mesh] evaluator {quant} under --distributed --mesh 1,1,1: CSV byte-equal to the plain run "
            f"{same_csv}, tokens equal {same_tokens}; LM parameters DTensors at every generate call {set(seen)} "
            f"({len(seen)} calls); {r['wall']:.1f} s (plain {plain['wall']:.1f} s), peak {r['peak'] / 2**30:.2f} "
            f"GiB (plain {plain['peak'] / 2**30:.2f} GiB)")
        _hold_launches("mesh-eval", r["launches"], per_quant[quant], n_batches)
        if not (same_csv and same_tokens) or seen != [quant == "none"] * n_batches:
            raise AssertionError(f"[mesh] evaluator {quant}: the one-rank mesh run is not the plain run")
        for k in launches:
            launches[k] += r["launches"][k]
        runs[quant] = dict(wall=r["wall"], peak=r["peak"], plain_wall=plain["wall"], plain_peak=plain["peak"])
    shutil.rmtree(base, ignore_errors=True)
    return dict(launches=launches, runs=runs)


PIXTRAL_SUBSET = "0.25"  # 5 of the 21 rows


def pixtral_phase(dev) -> dict:
    """[pixtral]: ``cli/evaluate_pixtral.py`` with its default student
    backend (the 0.5B at full width and depth, seed 0, bf16, flash) on 5
    rows of ``_eval_tree``: every row's answer equals ``extract_answer`` of
    the port's ``StudentAnswerer`` (``eval/runner.py``) called directly on
    the same row, the launches are exact (each row's prefill: K1 a SigLIP
    layer, K3 a decoder layer), and a backend that raises fails the CLI
    (the negative control: no exit with rows missing)."""
    import shutil

    import pandas as pd

    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli import evaluate_pixtral
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.data.dataset import (
        SUNRGBDVQADataset,
    )
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.eval import runner

    cfg = llava_onevision_0_5b()
    base = _build.BUILD_DIR.parent / "chip_smoke_pixtral"
    shutil.rmtree(base, ignore_errors=True)
    root = _eval_tree(base / "data")
    argv = ["--root_data_dir", root, "--subset_percentage", PIXTRAL_SUBSET, "--max_new_tokens", str(N_NEW)]
    r = _run_cli("pixtral", evaluate_pixtral, argv + ["--predictions_dir", str(base / "p")])
    rows = r["ret"]["rows"]
    _hold_launches("pixtral", r["launches"], {"flash_fwd_mha": cfg.vision.num_hidden_layers,
                                              "flash_fwd_gqa": cfg.text.num_hidden_layers}, len(rows))
    csv = pd.read_csv(r["ret"]["path"], keep_default_na=False)
    answer = runner.load_student_for_eval(None, max_new_tokens=N_NEW)
    ds = SUNRGBDVQADataset(root, "val_dataset.csv", float(PIXTRAL_SUBSET))
    direct = []
    for i in range(len(ds)):
        question, _, rgb, _, _ = ds[i]
        direct.append(evaluate_pixtral.extract_answer(answer(rgb, question + evaluate_pixtral.ADDITIONAL_INSTRUCTIONS)))
    got = [str(a) for a in csv["Model_Answer"]]
    log(f"[pixtral] {len(rows)} rows in {r['wall']:.1f} s ({len(rows) / r['wall']:.3f} rows/s), peak "
        f"{r['peak'] / 2**30:.2f} GiB; answers equal to the answerer called directly: {got == direct} ({[a[:40] for a in got[:2]]})")
    if len(rows) != len(ds) or got != direct or r["ret"]["errors"]:
        raise AssertionError(f"[pixtral] CLI answers {got} != the answerer's {direct}")
    del answer
    real = runner.load_student_for_eval

    def broken(*a, **k):
        def fail(image, question):
            raise RuntimeError("the answer backend failed")

        return fail

    runner.load_student_for_eval = broken
    try:
        evaluate_pixtral.main(argv + ["--predictions_dir", str(base / "broken")])
    except RuntimeError as e:
        log(f"[pixtral] negative control: a backend that raises fails the CLI ({e})")
    else:
        raise AssertionError("[pixtral] a raising backend did not fail the CLI")
    finally:
        runner.load_student_for_eval = real
    shutil.rmtree(base, ignore_errors=True)
    torch.cuda.empty_cache()
    return dict(launches=r["launches"], wall=r["wall"], peak=r["peak"], rows=len(rows))


PANESAR_CLASSES = 818  # the reference's answer classes
PANESAR_TRAIN_ROWS = 24  # --max_items: 3 steps of B=8; the 21 validation rows are the first 21
PANESAR_TOL = 1e-4  # relative Frobenius, card vs CPU, float32 with TF32 off
PANESAR_STEPS = 5


def _panesar_tree(root) -> str:
    """``_eval_tree``, its train split extended past the 21 rows (which
    are the validation rows) with rows of new answers over the same
    images, to the reference's 818 answer classes."""
    import pandas as pd

    _eval_tree(root)
    csv = root / "SUNRGBD" / "csv_data"
    df = pd.read_csv(csv / "train_dataset.csv")
    extra = PANESAR_CLASSES - df["Answers"].str.lower().nunique()
    more = df.iloc[[i % len(df) for i in range(extra)]].copy()
    more["Question_Id"] = range(len(df), len(df) + extra)
    more["Answers"] = [f"class {i}" for i in range(extra)]
    pd.concat([df, more]).to_csv(csv / "train_dataset.csv", index=False)
    return str(root)


def panesar_phase(dev) -> dict:
    """[panesar]: the Panesar VGG16+LSTM baseline (``cli/panesar_baseline.py``)
    at the reference's widths (224 x 224 images, B=8, conv1d fusion, 818
    answer classes), float32 with TF32 off.  First the card against the CPU
    on the same seeded model and two rows (B=2): the logits, then one
    Adadelta step (dropout off) and the updated fc1 and ``mlp`` leaves and
    their updates (relative Frobenius <= 1e-4).  Then the CLI: one epoch on
    24 rows (3 steps), the validation loss of its 21 rows (training rows
    too) below the seeded model's before training, every step's loss
    finite; then ``eval`` on the saved model.  No kernel of this repo
    launches (the JAX package runs it all through XLA)."""
    import copy
    import shutil

    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli import (
        panesar_baseline as pb,
    )
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.data.dataset import (
        SUNRGBDVQADataset,
    )

    base = _build.BUILD_DIR.parent / "chip_smoke_panesar"
    shutil.rmtree(base, ignore_errors=True)
    root = _panesar_tree(base / "data")
    flags = ["--root_data_dir", root, "--img_size", "224", "--batch_size", "8", "--fusion", "conv1d",
             "--max_items", str(PANESAR_TRAIN_ROWS), "--vocab_dir", str(base / "vocab"), "--ckpt",
             str(base / "ck" / "panesar.pt")]
    args = pb.build_parser().parse_args(["train", *flags])
    train_ds = SUNRGBDVQADataset(root, "train_dataset.csv")
    qwords, answers = pb.build_vocabs(train_ds, str(base / "vocab"))
    if len(answers) != PANESAR_CLASSES:
        raise AssertionError(f"[panesar] {len(answers)} answer classes")

    # card vs CPU, B=2
    t0 = time.perf_counter()
    cpu_model = pb.build_model(args, qwords, answers, args.seed, torch.device("cpu"))
    card_model = copy.deepcopy(cpu_model).to(dev)
    arrays = pb.encode_batch(train_ds, [0, 1], qwords, answers, img_size=224)
    pairs = [(cpu_model, pb.to_tensors(arrays, "cpu")), (card_model, pb.to_tensors(arrays, dev))]
    with torch.no_grad():
        logits = [m.eval()(*b[:3]) for m, b in pairs]
    errs = {"logits": _errors(logits[1].cpu(), logits[0])[1]}
    before = {k: v.clone() for k, v in cpu_model.state_dict().items()}
    for m, b in pairs:
        pb.train_step(m, pb.make_optimizer(m, args.lr), b, deterministic=True)
    after = [m.state_dict() for m, _ in pairs]
    for k in ("img_enc_rgb.fc1.weight", "img_enc_depth.fc1.weight", "mlp.weight"):
        errs[k] = _errors(after[1][k].cpu(), after[0][k])[1]
        errs[k + " update"] = _errors(after[1][k].cpu() - before[k], after[0][k] - before[k])[1]
    log(f"[panesar] card vs CPU at B=2, 224 x 224, float32 (relative Frobenius): "
        f"{ {k: f'{v:.3e}' for k, v in errs.items()} } ({time.perf_counter() - t0:.1f} s)")
    if max(v for k, v in errs.items() if not k.endswith("update")) > PANESAR_TOL:
        raise AssertionError(f"[panesar] the card disagrees with the CPU: {errs}")
    del cpu_model, pairs, logits, before, after

    # the steady step at B=8 (the CLI's epoch of 3 steps includes cuDNN's first-call set-up)
    batch = pb.to_tensors(pb.encode_batch(train_ds, range(8), qwords, answers, img_size=224), dev)
    opt, gen = pb.make_optimizer(card_model, args.lr), torch.Generator(device=dev).manual_seed(0)
    for _ in range(2):
        pb.train_step(card_model, opt, batch, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PANESAR_STEPS):
        pb.train_step(card_model, opt, batch, gen)
    torch.cuda.synchronize()
    steady_ms = (time.perf_counter() - t0) / PANESAR_STEPS * 1e3
    log(f"[panesar] steady train step at B=8 (mean of {PANESAR_STEPS} after 2): {steady_ms:.1f} ms "
        f"({8 / (steady_ms / 1e3):.1f} samples/s)")
    del card_model, opt, batch

    # the seeded model's loss on the validation rows, before training
    val_ds = SUNRGBDVQADataset(root, "val_dataset.csv")
    model = pb.build_model(args, qwords, answers, args.seed, dev).eval()
    num = den = 0.0
    with torch.no_grad():
        for start in range(0, len(val_ds), 8):
            rgb, depth, qids, ys, valid = pb.to_tensors(
                pb.encode_batch(val_ds, range(start, min(start + 8, len(val_ds))), qwords, answers, img_size=224), dev)
            ce = F.cross_entropy(model(rgb, depth, qids), ys, reduction="none")
            num, den = num + (ce * valid).sum().item(), den + valid.sum().item()
    initial = num / den
    del model
    torch.cuda.empty_cache()

    r = _run_cli("panesar", pb, ["train", *flags, "--epochs", "1"])
    rec = r["ret"]
    step_ms = rec["train_s"] / rec["steps"] * 1e3
    log(f"[panesar] train: {rec['steps']} steps of B=8, losses {rec['train_losses']}, validation loss "
        f"{initial:.4f} before -> {rec['val_losses'][0]:.4f} after the epoch; the CLI's training loop "
        f"{step_ms:.1f} ms of wall a step ({8 / (step_ms / 1e3):.1f} samples/s; host encoding "
        f"{rec['host_s'] / rec['steps'] * 1e3:.1f} ms a batch of it, the first step's set-up included), "
        f"{r['wall']:.1f} s, peak {r['peak'] / 2**30:.2f} GiB")
    if (rec["steps"] != 3 or not all(math.isfinite(x) for x in rec["train_losses"] + rec["val_losses"])
            or not rec["val_losses"][0] < initial):
        raise AssertionError(f"[panesar] training: {rec}, initial validation loss {initial}")
    e = _run_cli("panesar-eval", pb, ["eval", *flags])
    ev = e["ret"]
    log(f"[panesar] eval: accuracy {ev['accuracy']:.4f} ({ev['correct']}/{ev['total']}), "
        f"{ev['rows'] / ev['eval_s']:.1f} rows/s in the loop, {e['wall']:.1f} s, peak {e['peak'] / 2**30:.2f} GiB")
    if ev["total"] != len(val_ds) or "panesar eval accuracy" not in e["log"]:
        raise AssertionError(f"[panesar] eval: {e['log'][-500:]}")
    for run in (r, e):
        if any(run["launches"].values()):
            raise AssertionError(f"[panesar] a kernel of this repo launched: {run['launches']}")
    shutil.rmtree(base, ignore_errors=True)
    torch.cuda.empty_cache()
    return dict(launches=dict.fromkeys(COUNTERS, 0), step_ms=step_ms, steady_ms=steady_ms, peak=r["peak"],
                eval_rows_s=ev["rows"] / ev["eval_s"], errs=errs)


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Chip smoke test of the PyTorch/CUDA port.")
    ap.add_argument("--parent", default=None,
                    help="another checkout of the port (e.g. the parent commit unpacked by git archive): "
                         "time K1-K13 and the [train], [main], [kd], [kd1], [kdfb], [kd8] and [eval] runs "
                         "with its kernels beside this checkout's, and hold K1, K2, K4, K6 and K8-K12 "
                         "bit-equal to its output")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {card}")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    dev = common.setup_device(types.SimpleNamespace(cpu=False))  # cuda:0, TF32 off

    lib_path = _build.library_path()
    how = "loaded" if lib_path.exists() else "built"
    t0 = time.perf_counter()
    _build.load_library()
    log(f"[build] {how} {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    log_file = lib_path.with_suffix(".log")
    if log_file.exists():  # ptxas: registers, shared memory and spills per kernel
        entry = None
        for line in log_file.read_text().splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "Used" in line and entry:
                log(f"[build] {entry[:100]}: {line.split(':', 1)[1].strip()}")
            elif "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
                log(f"[build] {entry}: {line.strip()}")

    parent = None if args.parent is None else load_parent(args.parent)
    t_main = time.perf_counter()

    def mark(tag):
        log(f"[time] {tag} done at {time.perf_counter() - t_main:.1f} s of the phases")

    kernels = kernel_phase(dev, parent) + k13_phase(dev, parent)
    mark("kernels, k13")
    train = training_phase(dev)
    steps_parent = {}
    if parent is not None:
        steps_parent["train"] = steps_in_turns(parent, lambda tag: training_phase(dev, tag=tag), "train", train)
    agreement_phase(dev)
    mark("train, agreement")
    serve = main_path_phase(dev)
    if parent is not None:
        with parent_kernels(parent):
            steps_parent["main"] = main_path_phase(dev, tag="main-parent")
    serve8 = main8_phase(dev)
    mark("main, main8")
    teacher = _build_teacher(dev)
    kd = kd_training_phase(dev, teacher)
    if parent is not None:
        steps_parent["kd"] = steps_in_turns(parent, lambda tag: kd_training_phase(dev, teacher, tag=tag), "kd", kd)
    kdf = kd_faithful_phase(dev, teacher)
    kd1 = kd_phase1_phase(dev, teacher)
    if parent is not None:
        steps_parent["kd1"] = steps_in_turns(parent, lambda tag: kd_phase1_phase(dev, teacher, tag=tag), "kd1", kd1)
    kdfb = feature_based_phase(dev, teacher)
    if parent is not None:
        steps_parent["kdfb"] = steps_in_turns(parent, lambda tag: feature_based_phase(dev, teacher, tag=tag), "kdfb",
                                              kdfb)
    mark("kd, kdF, kd1, kdfb")
    remat = remat_phase(dev, teacher)  # before [kd8] quantizes the teacher in place
    mark("remat")
    kd8 = kd8_phase(dev, teacher)
    if parent is not None:
        steps_parent["kd8"] = steps_in_turns(parent, lambda tag: kd8_steps(dev, teacher, tag=tag), "kd8", kd8)
    del teacher
    torch.cuda.empty_cache()
    kd_agreement_phase(dev)
    kd_agreement_phase(dev, faithful=True)
    kd_agreement_phase(dev, int8=True)
    kd_phase1_agreement_phase(dev)
    mark("kd8, agreements")
    tiny_cli_phase()
    evals = eval_phase(dev, parent)
    mark("tiny, eval")
    created = create_phase(dev)
    mark("create")
    mesh = mesh_cli_phase(dev)
    rows = mesh_rows_phase(dev)
    mark("mesh (a), (b)")
    mesh_eval = mesh_eval_phase(dev, evals)
    mark("mesh (c)")
    pixtral = pixtral_phase(dev)
    mark("pixtral")
    panesar = panesar_phase(dev)
    mark("panesar")
    # launches: the driven paths, each counted from 0 around its own run
    # (K9's: the op path on a [kdF] micro-batch; the evaluator's runs; the
    # dataset creation's and its workflow's CLI runs; the remat settings'
    # steps; the mesh CLI runs; the evaluator under a mesh; the Pixtral CLI;
    # the Panesar CLI, which launches none)
    paths = (train, serve, serve8, kd, kdf, kdf["probe"], kd1, kdfb, kd8, evals, created, remat, mesh, mesh_eval,
             pixtral, panesar)
    for kr in kernels:
        kr["launches"] = sum(path["launches"][kr["name"]] for path in paths)
    log(f"[summary] {card}: train step {train['step_ms']:.1f} ms "
        f"({ACCUM / (train['step_ms'] / 1e3):.3f} samples/s), peak {train['peak'] / 2**30:.2f} GiB; "
        f"generate {serve['ms_call']:.1f} ms/call, int8_full {serve8['ms_call']:.1f} ms/call")
    for name, r in (("KD phase 3", kd), ("KD phase 3, faithful LoCa", kdf), ("KD phase 1", kd1),
                    ("feature_based", kdfb), ("KD phase 3, int8 teacher", kd8)):
        log(f"[summary] {card}: {name} step {r['step_ms']:.1f} ms "
            f"({ACCUM / (r['step_ms'] / 1e3):.3f} samples/s), peak {r['peak'] / 2**30:.2f} GiB")
    for name, r in (("train", train), ("kd", kd), ("kd1", kd1), ("kdfb", kdfb), ("kd8", kd8)):
        if name in steps_parent:
            log(f"[summary] {card}: [{name}] step {steps_parent[name]['change_ms']:.1f} ms, with the parent's "
                f"kernels {steps_parent[name]['step_ms']:.1f} ms (means of two runs each, in turns, same "
                f"call); last loss {r['losses'][-1]:.6f} vs {steps_parent[name]['losses'][-1]:.6f}; peak "
                f"{r['peak'] / 2**30:.2f} GiB vs {steps_parent[name]['peak'] / 2**30:.2f} GiB")
    if "main" in steps_parent:
        log(f"[summary] {card}: [main] generate {serve['ms_call']:.1f} ms/call, with the parent's kernels "
            f"{steps_parent['main']['ms_call']:.1f} ms/call (same call)")
    if evals["rows_s8_parent"] is not None:
        log(f"[summary] {card}: [eval] {evals['rows_s8']:.3f} rows/s at B={EVAL_BS}, with the parent's kernels "
            f"{evals['rows_s8_parent']:.3f} (same call)")
    log(f"[summary] {card}: evaluator {evals['rows_s8']:.3f} rows/s at B={EVAL_BS} (host "
        f"{evals['host8']:.2f} s, generate {evals['gen8']:.2f} s), {evals['rows_s1']:.3f} rows/s at B=1, "
        f"peak {evals['peak'] / 2**30:.2f} GiB")
    log(f"[summary] {card}: [create] dataset creation with the student color backend and the "
        f"create -> train 1/2/3 -> evaluate -> summary workflow {created['seconds']:.1f} s")
    for label, r in remat["runs"].items():
        samples = 2 if label.startswith("B=2") else ACCUM
        log(f"[summary] {card}: [remat] {label}: step {r['step_ms']:.1f} ms (host), device {r['device_ms']:.1f} ms, "
            f"{samples / (r['step_ms'] / 1e3):.3f} samples/s, peak {r['peak'] / 2**30:.2f} GiB")
    for label, r in mesh["runs"].items():
        log(f"[summary] {card}: [mesh] KD CLI {label}: {r['wall']:.1f} s, peak {r['peak'] / 2**30:.2f} GiB")
    log(f"[summary] {card}: [mesh] two ranks on the card, the row-sharded K5-K9 and K11: {rows['seconds']:.1f} s")
    for quant, r in mesh_eval["runs"].items():
        log(f"[summary] {card}: [mesh] evaluator {quant} at B={EVAL_BS} under --distributed --mesh 1,1,1: "
            f"{r['wall']:.1f} s ({EVAL_ROWS / r['wall']:.3f} rows/s), peak {r['peak'] / 2**30:.2f} GiB; plain "
            f"{r['plain_wall']:.1f} s ({EVAL_ROWS / r['plain_wall']:.3f} rows/s), peak {r['plain_peak'] / 2**30:.2f} GiB")
    log(f"[summary] {card}: [pixtral] student backend {pixtral['rows']} rows in {pixtral['wall']:.1f} s "
        f"({pixtral['rows'] / pixtral['wall']:.3f} rows/s), peak {pixtral['peak'] / 2**30:.2f} GiB")
    log(f"[summary] {card}: [panesar] 224 x 224, B=8, conv1d, {PANESAR_CLASSES} classes, float32: steady step "
        f"{panesar['steady_ms']:.1f} ms ({8 / (panesar['steady_ms'] / 1e3):.1f} samples/s); the CLI's training loop "
        f"{panesar['step_ms']:.1f} ms of wall a step (host encoding and set-up included), peak "
        f"{panesar['peak'] / 2**30:.2f} GiB; eval {panesar['eval_rows_s']:.1f} rows/s")
    log(f"[summary] {card}: teacher per micro-batch {kd8['teacher_ms_bf16']:.1f} ms bf16, "
        f"{kd8['teacher_ms']:.1f} ms int8")
    log(f"[summary] fused_kl_bwd dW launches: {sum(path['launches']['fused_kl_bwd_dw'] for path in paths)} "
        f"(phase 1 {kd1['launches']['fused_kl_bwd_dw']}, feature_based {kdfb['launches']['fused_kl_bwd_dw']})")

    print(card, flush=True)
    print(json.dumps({"kernels": [
        {k: kr[k] for k in ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                            "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for kr in kernels
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
