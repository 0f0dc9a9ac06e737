"""CSV merge / typo cleanup / balancing
(`dataset/dataset_creation/merge_all_csv_by_split.py`, `merge_all_csv.py`).

The port's copy of the JAX package's ``data/creation/merge.py``, which
imports no jax (``tests/test_torch_creation.py`` holds it to the original).

Parity:
* the ~25-entry typo replacement regex dict (`merge_all_csv_by_split.py:142-176`)
  with the column-scoped "red"->"bed" (Questions only) and "what?"->"hat"
  (Answers only) special cases;
* drop rows containing ``wall\\d+`` or exactly "i think" (`:222-234`);
* test/val balancing: equal Question_Type share of unique image paths +
  Yes/No halved 50/50 with random_state=42 (`:28-112,239-241`);
* 70/20/10 split variant (`merge_all_csv.py:75-88`);
* ``Question_Id`` insertion.
"""

from __future__ import annotations

import re
from typing import Dict, List

import pandas as pd

REPLACEMENT_DICT: Dict[str, str] = {
    r"\bouchs\b": "couches",
    r"\btouches\b": "couches",
    r"\btouchs\b": "couches",
    r"\bhairs\b": "chairs",
    r"\bwhat\?\b": "hat",
    r"\bdivided\b": "divider",
    r"\bdivideds\b": "divider",
    r"\bdesk tops\b": "desktops",
    r"\bdesk top\b": "desktops",
    r"\bots\b": "tvs",
    r"\battress\b": "matterss",
    r"\bchairperson\b": "chair",
    r"\bwater purified\b": "water purifier",
    r"\bconstable\b": "table",
    r"\bloveseat\b": "couch",
    r"\bmind fridge\b": "mini fridge",
    r"\bchase\b": "chair",
    r"\bhair\b": "chair",
    r"\bso far\b": "sofa",
    r"\btimes\b": "tiles",
    r"\bfaiting\b": "painting",
    r"\bshelling\b": "ceiling",
    r"\bcomfortable\b": "comforter",
    r"\bprotector screen\b": "projector screen",
    r"\bcurrent\b": "curtain",
    r"\bchart\b": "trash",
    r"\batble\b": "table",
    r"\bbacket\b": "bucket",
    r"\bauricle\b": "cubicle",
    r"\bpurified\b": "purifier",
}

RED_PATTERN = r"\bred\b"          # Questions column only -> "bed"
WHAT_PATTERN = r"\bwhat\?\b"      # Answers column only -> "hat"


def apply_typo_replacements(df: pd.DataFrame) -> pd.DataFrame:
    def fix_row(row):
        if pd.notna(row.get("Questions")):
            row["Questions"] = re.sub(
                RED_PATTERN, "bed", row["Questions"], flags=re.IGNORECASE
            )
        if pd.notna(row.get("Answers")):
            row["Answers"] = re.sub(
                WHAT_PATTERN, "hat", str(row["Answers"]), flags=re.IGNORECASE
            )
        for pattern, repl in REPLACEMENT_DICT.items():
            for col in ("Questions", "Answers"):
                if pd.notna(row.get(col)):
                    row[col] = re.sub(
                        pattern, repl, str(row[col]), flags=re.IGNORECASE
                    )
        return row

    return df.apply(fix_row, axis=1)


def drop_unwanted_rows(df: pd.DataFrame) -> pd.DataFrame:
    """`merge_all_csv_by_split.py:222-234`."""
    patterns_to_remove = r"wall\d+"
    exact = r"^i think$"
    q = df["Questions"].astype(str)
    a = df["Answers"].astype(str)
    keep = ~(
        q.str.contains(patterns_to_remove, case=False, na=False)
        | a.str.contains(patterns_to_remove, case=False, na=False)
        | q.str.match(exact, case=False, na=False)
        | a.str.match(exact, case=False, na=False)
    )
    return df[keep]


def balance_dataset_by_question_type(
    df: pd.DataFrame,
    question_type_col: str = "Question_Type",
    image_path_col: str = "Image_Path",
) -> pd.DataFrame:
    """`merge_all_csv_by_split.py:28-71`: partition sorted unique image
    paths into equal chunks, one per question type."""
    unique_paths = sorted(set(df[image_path_col].tolist()))
    per_type = len(unique_paths) // max(df[question_type_col].nunique(), 1)
    balanced = []
    remaining = unique_paths
    for qtype in df[question_type_col].unique():
        selected = set(remaining[:per_type])
        remaining = [p for p in remaining if p not in selected]
        rows = df[(df[question_type_col] == qtype) & df[image_path_col].isin(selected)]
        balanced.append(rows)
    return pd.concat(balanced, ignore_index=True) if balanced else df


def balance_yes_no_question_type(
    df: pd.DataFrame,
    question_type_col: str = "Question_Type",
    answers_col: str = "Answers",
) -> pd.DataFrame:
    """`merge_all_csv_by_split.py:75-112`: halve Yes/No rows, 50/50
    yes/no, random_state=42."""
    yes_no = df[df[question_type_col] == "Yes/No"]
    if yes_no.empty:
        return df
    yes_rows = yes_no[yes_no[answers_col].str.lower() == "yes"]
    no_rows = yes_no[yes_no[answers_col].str.lower() == "no"]
    target = len(yes_no) // 2
    n_yes = min(target // 2, len(yes_rows))
    n_no = min(target // 2, len(no_rows))
    sampled = pd.concat(
        [
            yes_rows.sample(n=n_yes, random_state=42),
            no_rows.sample(n=n_no, random_state=42),
        ],
        ignore_index=True,
    )
    rest = df[df[question_type_col] != "Yes/No"]
    return pd.concat([rest, sampled], ignore_index=True)


def process_split(
    dfs: List[pd.DataFrame], split_name: str
) -> pd.DataFrame:
    """Merge per-type CSVs for one split: typo cleanup, grey->gray, row
    drops, and balancing for test/validation (`:140-241`)."""
    df = pd.concat(dfs, ignore_index=True)
    # final split CSVs carry exactly these columns in this order — the data
    # layer addresses them positionally (iloc 1..4,
    # `CustomSUNRGBDDatasetOneVision.py:186-187,209-210`)
    df = df[["Questions", "Answers", "Image_Path", "Depth_Path", "Question_Type"]]
    df["Answers"] = (
        df["Answers"].astype(str).str.replace(r"\bgrey\b", "gray", regex=True)
    )
    df = apply_typo_replacements(df)
    df = drop_unwanted_rows(df)
    if split_name in ("test", "validation", "val"):
        df = balance_dataset_by_question_type(df)
        df = balance_yes_no_question_type(df)
    df = df.reset_index(drop=True)
    df.insert(0, "Question_Id", range(1, len(df) + 1))
    return df


def split_70_20_10(df: pd.DataFrame, seed: int = 42):
    """`merge_all_csv.py:75-88`: shuffled 70/20/10 train/val/test split."""
    shuffled = df.sample(frac=1.0, random_state=seed).reset_index(drop=True)
    n = len(shuffled)
    n_train = int(0.7 * n)
    n_val = int(0.2 * n)
    return (
        shuffled.iloc[:n_train].reset_index(drop=True),
        shuffled.iloc[n_train : n_train + n_val].reset_index(drop=True),
        shuffled.iloc[n_train + n_val :].reset_index(drop=True),
    )
