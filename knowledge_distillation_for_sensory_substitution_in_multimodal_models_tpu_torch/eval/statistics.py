"""Dataset sanity baselines & confidence intervals
(`evaluation/dataset_statistics/`).

The port's copy of the JAX package's ``eval/statistics.py``, which imports
no jax (``tests/test_torch_creation.py`` holds it to the original).

Ports (with the reference's latent bugs fixed — `oracle_model.py:6`
placeholder path and the `confidence_interval.py:39` syntax error,
SURVEY.md §2.5 #6):
* ``random_model`` — per-Question_Type random-guess accuracy vs expected
  1/N (`dataset_test_models/random_model.py:50-118`);
* ``oracle_model`` — ground-truth echo (`dataset_test_models/oracle_model.py:8-29`);
* normal + proportion confidence intervals
  (`statistics/confidence_interval.py:25-55`), scipy-free.
"""

from __future__ import annotations

import math
import random
from typing import Dict, Tuple

import pandas as pd

# Phi^-1((1+cl)/2) for the usual confidence levels (scipy-free).
_Z_SCORES = {0.90: 1.6448536269514722, 0.95: 1.959963984540054,
             0.99: 2.5758293035489004}


def _z(confidence_level: float) -> float:
    if confidence_level in _Z_SCORES:
        return _Z_SCORES[confidence_level]
    # Acklam-style rational approximation of the normal ppf
    from statistics import NormalDist

    return NormalDist().inv_cdf((1 + confidence_level) / 2)


def random_model(df: pd.DataFrame, seed: int = 0) -> Dict[str, Dict[str, float]]:
    """Random-guess accuracy per Question_Type with expected 1/N."""
    rng = random.Random(seed)
    unique_by_type = df.groupby("Question_Type")["Answers"].unique().to_dict()
    preds = [
        rng.choice(list(unique_by_type[row["Question_Type"]]))
        for _, row in df.iterrows()
    ]
    df = df.assign(Predicted_Answer=preds)
    out = {}
    for qtype, group in df.groupby("Question_Type"):
        n_unique = len(unique_by_type[qtype])
        out[str(qtype)] = {
            "Accuracy": float(
                (group["Answers"] == group["Predicted_Answer"]).mean()
            ),
            "Expected Accuracy": (100.0 / n_unique) if n_unique else 0.0,
        }
    return out


def oracle_model(df: pd.DataFrame, index: int) -> Tuple[str, str]:
    if index < 0 or index >= len(df):
        raise IndexError("Index out of range")
    row = df.iloc[index]
    return row["Questions"], row["Answers"]


def calculate_confidence_interval(
    data, confidence_level: float = 0.95
) -> Tuple[float, float]:
    data = pd.Series(data)
    mean, std, n = data.mean(), data.std(), len(data)
    margin = _z(confidence_level) * (std / math.sqrt(n))
    return mean - margin, mean + margin


def calculate_proportion_confidence_interval(
    data, confidence_level: float = 0.95, positive_value=2
) -> Tuple[float, float]:
    data = pd.Series(data)
    n = len(data)
    p_hat = float((data == positive_value).mean())
    margin = _z(confidence_level) * math.sqrt(p_hat * (1 - p_hat) / n)
    return max(0.0, p_hat - margin), min(1.0, p_hat + margin)
