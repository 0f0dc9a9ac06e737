"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (sm_90a, H100).

    python3 chip_smoke.py

Phases (any failure raises, and the exit code is non-zero):
  1. print the card's name and power limit; require CUDA;
  2. build the kernel library from the sources in this checkout
     (into build/kernels/) and print the build time;
  3. hold each kernel against its plain PyTorch version at the main path's
     shapes, in bf16 on the card (max abs error after an f32 cast <= 2e-2),
     and time both;
  4. drive the main path: greedy generation with the 0.5B depth student at
     full width and depth (seeded random weights, bf16) on the SUNRGBD
     production frame, with kernel launch counts read around it; check the
     tokens and the prefill logits, and that the kernel path agrees with the
     plain path;
  5. print one JSON line of kernel results, then the result line
     {"ok": true, "device": {...}} last.

Needs torch with CUDA, nvcc and numpy; imports no jax.  The model config and
the synthetic batch come from the JAX package's jax-free host modules
(numpy only), as the port's own modules do.
"""

from __future__ import annotations

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

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.configs import (  # noqa: E402
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
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops import (  # noqa: E402
    _build,
    flash_attention as fa,
)


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


def kernel_phase(dev) -> list:
    """Each kernel against its plain version at the main path's shapes."""
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    cases = [
        # SigLIP: 10 tiles x 729 tokens, 16 heads, d=72, non-causal, no mask
        dict(name="flash_fwd_mha", entry=fa.flash_attention, line=600,
             q=(10, 729, 16, 72), kv=(10, 729, 16, 72), causal=False, n_valid=None),
        # Qwen2 prefill: 3072 queries over the fresh 3104-slot cache, 14q/2kv,
        # d=64, causal, kv mask of the 2936-token SUNRGBD prompt
        dict(name="flash_fwd_gqa", entry=fa.flash_attention_gqa, line=1740,
             q=(1, 3072, 14, 64), kv=(1, 3104, 2, 64), causal=True, n_valid=2936),
    ]
    results = []
    for c in cases:
        q, k, v = randn(*c["q"]), randn(*c["kv"]), randn(*c["kv"])
        mask = None
        if c["n_valid"] is not None:
            mask = torch.zeros(c["kv"][0], c["kv"][1], dtype=torch.bool, device=dev)
            mask[:, : c["n_valid"]] = True

        def kernel():
            return c["entry"](q, k, v, mask=mask, causal=c["causal"])

        def plain():
            return fa.flash_attention_ref(q, k, v, mask, c["causal"])

        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        err = (got.float() - want.float()).abs().max().item()
        log(f"[kernel] {c['name']}: q {c['q']} kv {c['kv']} causal={c['causal']} "
            f"max_abs_err={err:.3e} (tol {KERNEL_TOL})")
        if not (err <= KERNEL_TOL):
            raise AssertionError(f"{c['name']} disagrees with its plain version: {err}")
        ms = time_ms(kernel, iters=20)
        plain_ms = time_ms(plain, iters=5, warmup=1)
        log(f"[kernel] {c['name']}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        results.append(dict(
            name=c["name"], route="cuda", source=f"{PKG}/csrc/flash_fwd.cu",
            replaces=f"{REF}/ops/flash_attention.py:{c['line']}",
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
        ))
    return results


def main_path_phase(dev) -> dict:
    """Greedy generation with the 0.5B student, full width and depth."""
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

    fa.reset_launch_counts()
    t0 = time.perf_counter()
    outs = [gen.generate(model, tb) for _ in range(GEN_CALLS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_fwd_mha": fa.flash_attention.launches,
                "flash_fwd_gqa": fa.flash_attention_gqa.launches}
    want = {"flash_fwd_mha": cfg.vision.num_hidden_layers * GEN_CALLS,
            "flash_fwd_gqa": cfg.text.num_hidden_layers * GEN_CALLS}
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
    if log_file.exists():
        for line in log_file.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {line.strip()}")

    kernels = kernel_phase(dev)
    main = main_path_phase(dev)
    for kr in kernels:
        kr["launches"] = main["launches"][kr["name"]]

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
