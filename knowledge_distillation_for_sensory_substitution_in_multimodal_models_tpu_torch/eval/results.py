"""Results aggregation: predictions CSVs -> summary rows.  A copy of the JAX
package's ``eval/results.py`` (which imports no jax), held to it by
``tests/test_torch_host_layer.py``.

Reference parity:
* ``evaluation/get_all_results.py:14-71``: scan ``dataset/predictions/*.csv``,
  compute metrics, append rows to
  ``dataset/predictions/summary/results_summary.csv`` incrementally
  (skipping files already summarized);
* ``evaluation/onevisionv3/get_results.py:16-37``: single-file variant.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, Optional

import pandas as pd

from .metrics import metrics_backend, per_category_metrics, summarize_predictions


def summarize_file(pred_csv: str) -> Dict[str, object]:
    df = pd.read_csv(pred_csv)
    row = summarize_predictions(df)
    row["File"] = os.path.basename(pred_csv)
    if "Simple_Accuracy_Per_Category" in row:
        row["Simple_Accuracy_Per_Category"] = json.dumps(
            row["Simple_Accuracy_Per_Category"]
        )
    return row


def update_summary(
    predictions_dir: str, summary_csv: Optional[str] = None
) -> pd.DataFrame:
    """Append metrics rows for any prediction CSV not yet summarized."""
    summary_csv = summary_csv or os.path.join(
        predictions_dir, "summary", "results_summary.csv"
    )
    os.makedirs(os.path.dirname(summary_csv), exist_ok=True)
    existing = (
        pd.read_csv(summary_csv) if os.path.exists(summary_csv) else pd.DataFrame()
    )
    seen = set(existing["File"]) if "File" in existing.columns else set()
    rows = []
    for path in sorted(glob.glob(os.path.join(predictions_dir, "*.csv"))):
        if os.path.basename(path) in seen:
            continue
        rows.append(summarize_file(path))
    if rows:
        out = pd.concat([existing, pd.DataFrame(rows)], ignore_index=True)
        out.to_csv(summary_csv, index=False)
        return out
    return existing
