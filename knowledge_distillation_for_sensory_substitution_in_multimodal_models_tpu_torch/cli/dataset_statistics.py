"""Dataset statistics CLI (port of the JAX package's
``cli/dataset_statistics.py``, over the port's ``cli/common.py`` and its copy
of ``eval/statistics.py``; parity with `evaluation/dataset_statistics/`:
`random_model.py:50-118`, `oracle_model.py:8-29`,
`confidence_interval.py:22-64` — the latter two are broken in the
reference: a placeholder data path and a syntax error).

Prints per-Question_Type random-guess accuracy vs the expected 1/N
baseline, the oracle (ground-truth echo) accuracy, and normal/proportion
confidence intervals for a given accuracy.

Offline smoke on the CPU (the 12-row synthetic tree):
  python -m knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli.dataset_statistics \\
      --synthetic_data --accuracy 0.45
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root_data_dir", type=str, default=None)
    p.add_argument("--gts_type", type=str, default="val",
                   choices=["train", "val", "test"])
    p.add_argument("--accuracy", type=float, default=None,
                   help="accuracy value to wrap in confidence intervals")
    p.add_argument("--n", type=int, default=None,
                   help="sample count for the CI (defaults to dataset size)")
    p.add_argument("--confidence", type=float, default=0.95)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic_data", action="store_true")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import pandas as pd

    from . import common
    from ..eval.statistics import (
        calculate_confidence_interval,
        calculate_proportion_confidence_interval,
        oracle_model,
        random_model,
    )

    common.load_env()
    root = args.root_data_dir or os.environ.get("ROOT_DATA_DIR")
    if args.synthetic_data:
        import tempfile

        root = common.ensure_synthetic_dataset(
            root or tempfile.mkdtemp(prefix="kdss_synth_")
        )
    if not root:
        raise SystemExit("set ROOT_DATA_DIR or pass --root_data_dir / --synthetic_data")

    csv = os.path.join(root, "SUNRGBD/csv_data", f"{args.gts_type}_dataset.csv")
    df = pd.read_csv(csv)
    print(f"{args.gts_type}: {len(df)} rows, "
          f"{df['Question_Type'].nunique()} question types")

    stats = random_model(df, seed=args.seed)
    rows = [
        {"Question_Type": k, **v} for k, v in sorted(stats.items())
    ]
    print("\nrandom-guess baseline (vs expected 1/N):")
    print(pd.DataFrame(rows).to_string(index=False))

    q, a = oracle_model(df, 0)
    print(f"\noracle check (row 0): {q!r} -> {a!r} (accuracy 1.0 by "
          "construction)")

    acc = args.accuracy
    if acc is not None:
        n = args.n or len(df)
        # Bernoulli sample matching the accuracy (the CI helpers take the
        # per-row correctness vector, reference `confidence_interval.py`)
        hits = round(acc * n)
        data = [2] * hits + [0] * (n - hits)
        lo, hi = calculate_confidence_interval(
            [1 if d == 2 else 0 for d in data], args.confidence
        )
        plo, phi = calculate_proportion_confidence_interval(
            data, args.confidence
        )
        print(f"\n{args.confidence:.0%} CI for accuracy {acc} over n={n}:")
        print(f"  normal:     [{lo:.4f}, {hi:.4f}]")
        print(f"  proportion: [{plo:.4f}, {phi:.4f}]")


if __name__ == "__main__":
    main()
