"""Per-phase cost accounting of the port's causal GQA flash forward (K3) on
the card, by ablation: the PyTorch/CUDA counterpart of
scripts/flash_phase_ablation.py's main().

Every arm (``ops/flash_phase_ablation.py``; the kernel is
``csrc/flash_gqa_sm90.cuh`` with its ``ARM`` template parameter) keeps K3's schedule,
tiles and memory traffic and drops or replaces one phase of the online
softmax; differences of the arms' times attribute K3's time to its phases.
Each arm is first held to its plain version (and the exact arms to
``full``), then timed with CUDA events over back-to-back launches.  Prints
the card's name and power limit, the per-arm times, the "full minus arm"
deltas and the phase accounting against the tensor-core speed of light
(989 TFLOP/s bf16, the H100's dense peak).

Defaults: the 0.5B student's prefill attention (B=1, 14 q / 2 kv heads,
S=3072, d=64); ``--heads 28 --kv_heads 4 --head_dim 128`` gives the 7B's.
Inputs are standard normal bf16 from a fixed seed.

Usage (on the card): python scripts/torch_flash_phase_ablation.py
    [--arms full,noexp,nored,nomax,nosum,mxu | all] [--iters 50] [--seq 3072]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops import (  # noqa: E402
    flash_phase_ablation as k13,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--seq", type=int, default=3072)
    ap.add_argument("--heads", type=int, default=14)
    ap.add_argument("--kv_heads", type=int, default=2)
    ap.add_argument("--head_dim", type=int, default=64, choices=k13.HEAD_DIMS)
    ap.add_argument("--arms", default="full,noexp,nored,nomax,nosum,mxu",
                    help=f"comma-separated, or 'all': {','.join(k13.ARMS)}")
    args = ap.parse_args(argv)
    arms = k13.ARMS if args.arms == "all" else tuple(args.arms.split(","))
    unknown = set(arms) - set(k13.ARMS)
    if unknown:
        raise SystemExit(f"unknown arms {sorted(unknown)}; choose from {k13.ARMS}")
    if not torch.cuda.is_available():
        raise SystemExit("this script measures the card: torch.cuda.is_available() is False")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {card}", flush=True)

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    b, s, d = 1, args.seq, args.head_dim
    q, k, v = (torch.randn(b, s, h, d, generator=g, device=dev).to(torch.bfloat16)
               for h in (args.heads, args.kv_heads, args.kv_heads))
    full = k13.phase_ablation_forward(q, k, v, "full")
    ms = {}
    for arm in arms:
        got = k13.phase_ablation_forward(q, k, v, arm)
        check = k13.check_arm(got, k13.phase_ablation_ref(q, k, v, arm), arm)
        if check is None or not (check[0] <= check[1] and check[2] <= 1e-2):
            raise SystemExit(f"{arm} disagrees with its plain version: {check}")
        line = f"{arm}-vs-plain max abs err: {check[0]:.2e}"
        if arm in k13.EXACT_ARMS:
            vs_full = (got.float() - full.float()).abs().max().item()
            line += f"; vs full {vs_full:.2e}"
            if not vs_full <= k13.TOL:
                raise SystemExit(f"{arm} arm diverged from full: {vs_full}")
        ms[arm] = k13.time_arm(q, k, v, arm, args.iters)
        print(f"{arm:15s} {ms[arm]:.4f} ms/pass  (blocks bq, bk = {k13.KERNEL_BLOCK[args.head_dim]}); {line}",
              flush=True)
    for line in k13.accounting(ms, s, args.heads, d, b):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
