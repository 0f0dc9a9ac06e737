"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (sm_90a, H100).

    python3 chip_smoke.py

Phases (any failure raises, and the exit code is non-zero):
  1. print the card's name and power limit; require CUDA;
  2. build the kernel library from the sources in this checkout
     (into build/kernels/, one nvcc per source, in parallel) and print the
     build time;
  3. hold each of the six kernels against its plain PyTorch version at the
     main paths' shapes, in bf16 on the card (max abs error after an f32
     cast <= 2e-2, dW by a relative bound on its max norm, and every output
     by its relative Frobenius error <= 1e-2), show that these bounds fail
     a flash backward that drops delta and a fused CE backward that drops
     its softmax term, and time kernel and plain version;
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
  6. print one JSON line of kernel results, then the result line
     {"ok": true, "device": {...}} last.

Needs torch with CUDA, nvcc and numpy; imports no jax.  The model config and
the synthetic batch come from the JAX package's jax-free host modules
(numpy only), as the port's own modules do.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import types

import torch

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

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.configs import (  # noqa: E402
    TrainConfig,
    llava_onevision_0_5b,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.utils.synthetic import (  # noqa: E402
    synthetic_kd_batch,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli import (  # noqa: E402
    common,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.eval.decode import (  # noqa: E402
    GenerateConfig,
    Generator,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.models import (  # noqa: E402
    set_attn_impl,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.losses import (  # noqa: E402
    masked_cross_entropy,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops import (  # noqa: E402
    _build,
    flash_attention as fa,
    fused_ce as fc,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.train import (  # noqa: E402
    KDModels,
    TrainState,
    make_loss_fn,
    make_optimizer,
    make_train_step,
)

# name -> (source, the TPU kernel it replaces, its launch counter)
KERNELS = {
    "flash_fwd_mha": ("csrc/flash_fwd.cu", "ops/flash_attention.py:600", fa.flash_attention),
    "flash_fwd_gqa": ("csrc/flash_fwd.cu", "ops/flash_attention.py:1740", fa.flash_attention_gqa),
    "flash_bwd_mha": ("csrc/flash_bwd.cu", "ops/flash_attention.py:743", fa.flash_attention_bwd),
    "flash_bwd_gqa": ("csrc/flash_bwd.cu", "ops/flash_attention.py:1870", fa.flash_attention_gqa_bwd),
    "fused_ce_fwd": ("csrc/fused_ce.cu", "ops/fused_ce.py:238", fc.lse_gold_fwd),
    "fused_ce_bwd": ("csrc/fused_ce.cu", "ops/fused_ce.py:284", fc.lse_gold_bwd),
}


def reset_counts() -> None:
    fa.reset_launch_counts()
    fc.reset_launch_counts()


def read_counts() -> dict:
    return {name: k[2].launches for name, k in KERNELS.items()}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _result(name, err, ms, plain_ms) -> dict:
    src, line, _ = KERNELS[name]
    log(f"[kernel] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, max_abs_err={err:.3e}")
    return dict(name=name, route="cuda", source=f"{PKG}/{src}", replaces=f"{REF}/{line}",
                max_abs_err=err, ms=ms, plain_ms=plain_ms)


def _errors(got, want):
    """(max abs error, relative Frobenius error) of one output, in f32."""
    diff = got.float() - want.float()
    return diff.abs().max().item(), (diff.norm() / want.float().norm()).item()


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


def kernel_phase(dev) -> list:
    """Each kernel against its plain version at the main paths' shapes."""
    g = torch.Generator(device=dev).manual_seed(0)

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
    ]
    for c in fwd_cases:
        q, k, v = randn(*c["q"]), randn(*c["kv"]), randn(*c["kv"])
        mask = kv_mask(c["kv"][0], c["kv"][1], c["n_valid"])

        def kernel():
            return c["entry"](q, k, v, mask=mask, causal=c["causal"])

        def plain():
            return fa.flash_attention_ref(q, k, v, mask, c["causal"])

        got = kernel()
        torch.cuda.synchronize()
        err = _hold(c["name"], [("out", got, plain(), KERNEL_TOL)])
        results.append(_result(c["name"], err, time_ms(kernel, iters=20), time_ms(plain, iters=5, warmup=1)))

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
        # a backward that drops delta from dS = P * (dP - delta)
        no_delta = c["entry"](q, k, v, dout, lse, torch.zeros_like(delta), mask=mask, causal=c["causal"])
        _must_fail(c["name"], "delta = 0", list(zip(no_delta[:2], want[:2])))
        del got, want, no_delta
        results.append(_result(c["name"], err, time_ms(kernel, iters=10), time_ms(plain, iters=3, warmup=1)))

    # Fused CE over the tied head: B*S = 3072 rows, the 151936 x 896 embedding.
    cfg = llava_onevision_0_5b()
    n, d, vocab = 3072, cfg.text.hidden_size, cfg.text.vocab_size
    h, w = randn(n, d), randn(vocab, d, std=0.02)
    labels = torch.randint(0, vocab, (n,), generator=g, device=dev, dtype=torch.int32)
    got = fc.lse_gold_fwd(h, w, labels)
    torch.cuda.synchronize()
    lse, gold = fc.lse_gold_ref(h, w, labels)
    err = _hold("fused_ce_fwd", [("lse", got[0], lse, KERNEL_TOL), ("gold", got[1], gold, KERNEL_TOL)])
    results.append(_result("fused_ce_fwd", err, time_ms(lambda: fc.lse_gold_fwd(h, w, labels), iters=5),
                           time_ms(lambda: fc.lse_gold_ref(h, w, labels), iters=3, warmup=1)))

    # Unit cotangents (the summed NLL).  With g_gold = -1 the gold term
    # -w_label dominates dh and dW; with g_gold = 0 they are the softmax
    # term sum_v p_v w_v alone, which a kernel must get right on its own.
    ones = torch.ones(n, device=dev)
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
    results.append(_result("fused_ce_bwd", err,
                           time_ms(lambda: fc.lse_gold_bwd(h, w, labels, lse, ones, g_gold), iters=3),
                           time_ms(lambda: fc.lse_gold_bwd_ref(h, w, labels, lse, ones, g_gold),
                                   iters=2, warmup=1)))
    del h, w
    torch.cuda.empty_cache()
    return results


def _device_batch(batch, dev) -> dict:
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items() if not k.startswith("teacher_")}


def training_phase(dev) -> dict:
    """8 baseline train steps of the 0.5B student, full width and depth."""
    cfg = llava_onevision_0_5b()
    t0 = time.perf_counter()
    model = common.init_or_load_params(cfg, None, seed=0, attn_impl="flash", device=dev,
                                       dtype=torch.bfloat16, trainable=True)
    batch = synthetic_kd_batch(cfg, 1, seq_len=3072, orig_sizes=[(530, 730)], accum=ACCUM, seed=3)
    tb = _device_batch(batch, dev)
    tcfg = TrainConfig(kd_mode="baseline", accumulate_grad_batches=ACCUM, learning_rate=LR,
                       cosine_t_max=0)
    state = TrainState(model, make_optimizer(model, LR))
    step = make_train_step(KDModels(model), tcfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[train] model ({n_params / 1e6:.1f} M params, bf16; float32 masters) + batch set-up "
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
    want = {k: n * ACCUM * TRAIN_STEPS for k, n in per_step.items()}
    log(f"[train] launches over {TRAIN_STEPS} steps: {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"training launch counts {launches} != {want}")
    timed = times[WARMUP_STEPS:]
    step_ms = sum(timed) / len(timed)
    log(f"[train] loss per step: {', '.join(f'{x:.6f}' for x in losses)}")
    log(f"[train] step ms: {', '.join(f'{x:.1f}' for x in times)}; mean of the {len(timed)} steps after "
        f"{WARMUP_STEPS} warm-up steps {step_ms:.1f} ms (min {min(timed):.1f}, max {max(timed):.1f}), "
        f"{ACCUM / (step_ms / 1e3):.3f} samples/s; peak memory "
        f"{peak / 2**30:.2f} GiB (max_memory_allocated)")
    frac, mean_step = probe_moved
    log(f"[train] float32 master of {MASTER_PROBE}, entries with 0.015 <= |w| <= 0.025: "
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
    full = llava_onevision_0_5b()
    cfg = dataclasses.replace(
        full, vision=dataclasses.replace(full.vision, num_hidden_layers=2),
        text=dataclasses.replace(full.text, num_hidden_layers=2))
    model = common.init_or_load_params(cfg, None, seed=1, attn_impl="flash", device=dev,
                                       dtype=torch.bfloat16, trainable=True)
    batch = synthetic_kd_batch(cfg, 1, seq_len=3072, orig_sizes=[(530, 730)], seed=3)
    tb = _device_batch(batch, dev)
    names = ("language_model.embed_tokens.weight", "language_model.layers.0.self_attn.q_proj.weight",
             "vision_tower.layers.0.mlp.fc1.weight")
    params = dict(model.named_parameters())
    leaves = [params[n] for n in names]

    reset_counts()
    loss_k, _ = make_loss_fn(KDModels(model), TrainConfig(kd_mode="baseline"))(tb)
    grads_k = torch.autograd.grad(loss_k, leaves)
    launches = read_counts()
    if min(launches.values()) == 0:
        raise AssertionError(f"the kernel path skipped a kernel: {launches}")

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
        cos = torch.nn.functional.cosine_similarity(gk.float().flatten(), gp.float().flatten(), dim=0).item()
        log(f"[agree] grad {n}: cosine {cos:.6f} (tol {GRAD_COSINE}), "
            f"norms {gk.float().norm().item():.4e} / {gp.float().norm().item():.4e}")
        if not (cos >= GRAD_COSINE):
            raise AssertionError(f"kernel and plain gradients of {n} disagree: cosine {cos}")
    del model, grads_k, grads_p
    torch.cuda.empty_cache()


def main_path_phase(dev) -> dict:
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
    log(f"[main] model + batch set-up {time.perf_counter() - t0:.1f} s; "
        f"prompt {int(tb['student_attention_mask'].sum())} tokens in a {tb['student_input_ids'].shape[1]} bucket")

    gen.generate(model, tb)  # warm-up (allocator, cuBLAS handles)
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    outs = [gen.generate(model, tb) for _ in range(GEN_CALLS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    want = dict.fromkeys(KERNELS, 0)
    want.update(flash_fwd_mha=cfg.vision.num_hidden_layers * GEN_CALLS,
                flash_fwd_gqa=cfg.text.num_hidden_layers * GEN_CALLS)
    log(f"[main] launches over {GEN_CALLS} generate calls: {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")

    ms_call = wall * 1e3 / GEN_CALLS
    tok_s = N_NEW * tb["student_input_ids"].shape[0] / (wall / GEN_CALLS)
    log(f"[main] generate: {ms_call:.1f} ms/call, {tok_s:.1f} tok/s "
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
    cos = torch.nn.functional.cosine_similarity(flash_next, plain_next, dim=0).item()
    same_argmax = int(flash_next.argmax()) == int(plain_next.argmax())
    log(f"[main] prefill {prefill_ms:.1f} ms; decode {(ms_call - prefill_ms) / (N_NEW - 1):.2f} ms/step "
        f"(from the generate time)")
    log(f"[main] next-token logits, flash vs plain path: max_abs_diff={diff:.4e} "
        f"(max |logit| {scale:.3f}), cosine={cos:.6f}, same argmax={same_argmax}")
    if not (cos >= PATH_COSINE):
        raise AssertionError(f"kernel path and plain path disagree (cosine {cos})")
    return dict(launches=launches, ms_call=ms_call, tok_s=tok_s)


def main() -> int:
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

    kernels = kernel_phase(dev)
    train = training_phase(dev)
    agreement_phase(dev)
    serve = main_path_phase(dev)
    # launches: the two driven paths, each counted from 0 around its own run
    for kr in kernels:
        kr["launches"] = train["launches"][kr["name"]] + serve["launches"][kr["name"]]
    log(f"[summary] {card}: train step {train['step_ms']:.1f} ms "
        f"({ACCUM / (train['step_ms'] / 1e3):.3f} samples/s), peak {train['peak'] / 2**30:.2f} GiB; "
        f"generate {serve['ms_call']:.1f} ms/call")

    print(card, flush=True)
    print(json.dumps({"kernels": [
        {k: kr[k] for k in ("name", "route", "source", "replaces", "launches",
                            "max_abs_err", "ms", "plain_ms")}
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
