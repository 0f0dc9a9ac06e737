"""Sweep the block shapes of the port's K3 and K12 kernels on the card.

    python scripts/torch_kernel_sweep.py [--variants gqa64=3,64,4 gqa128=2,128,2 gemm=2,128,6 ...]

K3's block at each head dim (``csrc/flash_gqa_sm90.cuh``, ``Shape<D>``:
consumer warpgroups, kv tile rows, K/V stages) and K12's XLA-form and
K-block-form tiles (``csrc/int8_mm.cu``, ``GemmXla`` / ``GemmKBlock``:
warpgroups, B tile rows, stages) are compile-time constants.  For each
variant the script copies this checkout's kernel sources and launchers
under ``build/sweep/<n>/``, rewrites the one constant line, builds that copy
(``chip_smoke.load_parent``), and times this checkout's kernel and the
variant's in turns (this, variant, variant, this; CUDA events), after
holding the variant's output to its plain version (K3: max abs error <=
2e-2; K12: bit-equal).  K3 is timed at the student's and the teacher's
prefill (kv mask, causal) and at K13's shape (S = 3072, causal, no mask);
K12 at the teacher's gate_proj and down_proj and SigLIP's fc2 (and K12's
K-block form at gate_proj with K blocks of 512).  A variant that does not
build (shared memory past the block's limit) is reported and skipped.
Prints the card's name and power limit first.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
import types

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

# variant kind -> (source file, the pattern of its constant line, the line's template)
KINDS = {
    "gqa64": ("flash_gqa_sm90.cuh",
              r"struct Shape<64> \{\n  static constexpr int WGS = \d+, BK = \d+, STAGES = \d+;",
              "struct Shape<64> {{\n  static constexpr int WGS = {0}, BK = {1}, STAGES = {2};"),
    "gqa128": ("flash_gqa_sm90.cuh",
               r"struct Shape<128> \{\n  static constexpr int WGS = \d+, BK = \d+, STAGES = \d+;",
               "struct Shape<128> {{\n  static constexpr int WGS = {0}, BK = {1}, STAGES = {2};"),
    "gemm": ("int8_mm.cu", r"using GemmXla = Gemm<\d+, \d+, \d+, false, false>;",
             "using GemmXla = Gemm<{0}, {1}, {2}, false, false>;"),
    "gemmkb": ("int8_mm.cu", r"using GemmKBlock = Gemm<\d+, \d+, \d+, false, true>;",
               "using GemmKBlock = Gemm<{0}, {1}, {2}, false, true>;"),
}
DEFAULT = ("gqa64=3,64,8", "gqa64=2,128,4", "gqa128=2,128,2", "gqa128=3,64,4",
           "gemm=2,256,3", "gemm=2,128,6", "gemmkb=2,128,4")


def make_variant(n: int, spec: str) -> str:
    """Copy the kernel sources and launchers to build/sweep/<n>/ with the
    constant line of ``spec`` (kind=a,b,c) rewritten; return the copy's root."""
    kind, values = spec.split("=")
    src, pattern, line = KINDS[kind]
    root = os.path.join(ROOT, "build", "sweep", str(n))
    shutil.rmtree(root, ignore_errors=True)
    pkg = os.path.join(root, cs.PKG)
    shutil.copytree(os.path.join(ROOT, cs.PKG, "csrc"), os.path.join(pkg, "csrc"))
    os.makedirs(os.path.join(pkg, "ops"))
    shutil.copy(os.path.join(ROOT, cs.PKG, "ops", "_build.py"), os.path.join(pkg, "ops"))
    path = os.path.join(pkg, "csrc", src)
    text = open(path).read()
    new, count = re.subn(pattern, line.format(*values.split(",")), text)
    if count != 1:
        raise SystemExit(f"{spec}: the constant line of {src} was not found")
    with open(path, "w") as f:
        f.write(new)
    return root


def k3_cases(dev, g, d):
    """(label, q, k, v, mask) at K3's main-path shapes of head dim d."""
    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    hq, hkv, skv = (14, 2, 3104) if d == 64 else (28, 4, 3072)
    mask = torch.zeros(1, skv, dtype=torch.bool, device=dev)
    mask[:, :2936] = True
    q, k, v = randn(1, 3072, hq, d), randn(1, skv, hkv, d), randn(1, skv, hkv, d)
    k13q, k13k, k13v = randn(1, 3072, hq, d), randn(1, 3072, hkv, d), randn(1, 3072, hkv, d)
    return [(f"prefill d={d}, kv mask", q, k, v, mask), (f"K13 shape d={d}, no mask", k13q, k13k, k13v, None)]


def sweep_k3(variant, spec, dev, g) -> None:
    d = 64 if spec.startswith("gqa64") else 128
    for label, q, k, v, mask in k3_cases(dev, g, d):
        def kernel():
            with torch.no_grad():
                return cs.fa.flash_attention_gqa(q, k, v, mask=mask, causal=True)

        with cs.parent_kernels(variant):
            got = kernel()
        torch.cuda.synchronize()
        err = (got.float() - cs.fa.flash_attention_ref(q, k, v, mask, True).float()).abs().max().item()
        if not err <= cs.KERNEL_TOL:
            raise AssertionError(f"{spec} {label}: max abs error {err}")
        ms = [cs.time_ms(fn, iters=20) for fn in (kernel, cs._theirs(variant, kernel), cs._theirs(variant, kernel),
                                                  kernel)]
        print(f"[sweep] {spec} K3 {label}: this / variant / variant / this ms: "
              + " / ".join(f"{t:.4f}" for t in ms) + f"; variant max abs error {err:.3e}", flush=True)


def sweep_k12(variant, spec, dev, g) -> None:
    cases = [c for c in cs.INT8_CASES if c[1] > 8 and (c[4] is None) == (spec.startswith("gemm="))]
    for label, n, k, m, kb in cases:
        x = torch.randn(n, k, generator=g, device=dev).to(torch.bfloat16)
        wq, ws = cs.i8.absmax_quantize_weight(torch.randn(m, k, generator=g, device=dev) * 0.02)

        def kernel():
            return cs.i8.int8_matmul(x, wq, ws, k_block=kb)

        with cs.parent_kernels(variant):
            got = kernel()
        torch.cuda.synchronize()
        if not torch.equal(got, cs.i8.int8_matmul_ref(x, wq, ws, k_block=kb)):
            raise AssertionError(f"{spec} {label}: not bit-equal to the plain version")
        ms = [cs.time_ms(fn, iters=10) for fn in (kernel, cs._theirs(variant, kernel), cs._theirs(variant, kernel),
                                                  kernel)]
        print(f"[sweep] {spec} K12 {label}: this / variant / variant / this ms: "
              + " / ".join(f"{t:.4f}" for t in ms) + "; bit-equal to its plain version", flush=True)
        del x, wq, ws, got


def ptxas_lines(lib, spec: str) -> list:
    """The build log's registers and spills of the swept kernel's
    instantiations (K3's full arm; K12's GEMMs)."""
    key = "kdss_gqa90" if spec.startswith("gqa") else "gemm_kernel"
    lines, entry = [], None
    for line in lib.library_path().with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and key in entry and ("ELi0EE" in entry or key == "gemm_kernel") and (
                "Used" in line or "spill stores" in line):
            lines.append(f"{entry[:60]}: {line.split(':', 1)[-1].strip()}")
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--variants", nargs="+", default=list(DEFAULT),
                    help="kind=a,b,c with kind one of " + ", ".join(KINDS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip(), flush=True)
    dev = cs.common.setup_device(types.SimpleNamespace(cpu=False))
    cs._build.load_library()
    g = torch.Generator(device=dev).manual_seed(0)
    for n, spec in enumerate(args.variants):
        try:
            variant = cs.load_parent(make_variant(n, spec))
        except RuntimeError as e:  # a variant that does not build
            print(f"[sweep] {spec}: does not build: {str(e).splitlines()[-1][:200]}", flush=True)
            continue
        for line in ptxas_lines(variant, spec):
            print(f"[sweep] {spec} ptxas {line}", flush=True)
        (sweep_k3 if spec.startswith("gqa") else sweep_k12)(variant, spec, dev, g)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
