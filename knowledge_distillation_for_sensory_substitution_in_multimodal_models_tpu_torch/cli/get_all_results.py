"""Standalone results aggregator (port of the JAX package's
``cli/get_all_results.py``, every flag; parity with
`evaluation/get_all_results.py:14-71` and
`evaluation/onevisionv3/get_results.py:16-37`).

Scans a predictions directory for ``*.csv``, computes simple accuracy /
neural similarity (+ per-Question_Type breakdowns, + BERTScore stats
with ``--bert``) and appends new files incrementally to
``summary/results_summary.csv`` — the reference's de-facto benchmark
record.  ``--file`` scores a single CSV instead (the onevisionv3
single-file variant).
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--predictions_dir", type=str,
                   default="dataset/predictions")
    p.add_argument("--file", type=str, default=None,
                   help="score one predictions CSV and print the row")
    p.add_argument("--bert", action="store_true",
                   help="also compute BERTScore mean/std (bert_score when "
                        "installed, hashed-chargram F1 offline)")
    p.add_argument("--metric_backend", type=str, default="auto",
                   choices=["auto", "spacy", "hashed"],
                   help="spacy: hard-fail unless spaCy+en_core_web_md is "
                        "importable (reference-exact metrics; required for "
                        "BASELINE.md comparisons). hashed: force the "
                        "documented offline fallback. auto: spaCy when "
                        "available")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import pandas as pd

    from ..eval.metrics import bert_backend, compute_bert_stats, force_backend
    from ..eval.results import summarize_file, update_summary

    force_backend(args.metric_backend)

    if args.file:
        row = summarize_file(args.file)
        if args.bert:
            df = pd.read_csv(args.file)
            mean, std = compute_bert_stats(df["Model_Answer"], df["Answers"])
            row["BERTScore_F1_Mean"] = mean
            row["BERTScore_F1_Std"] = std
            row["BERT_Backend"] = bert_backend()
        print(pd.DataFrame([row]).to_string(index=False))
        return

    summary = update_summary(args.predictions_dir)
    print(summary.to_string(index=False))


if __name__ == "__main__":
    main()
