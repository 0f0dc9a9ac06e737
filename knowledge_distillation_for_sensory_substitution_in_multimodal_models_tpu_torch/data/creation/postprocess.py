"""Answer text post-processing (`dataset/dataset_creation/post_process.py`).

The port's copy of the JAX package's ``data/creation/postprocess.py``, which
imports no jax (``tests/test_torch_creation.py`` holds it to the original).

Pipeline parity (`process_text_only`, `post_process.py:43-67`):
1. split concatenated words via ``combined_words_mapping.csv``;
2. numbers -> words;
3. strip trailing digits from words;
4. spell-correct: word-level Norvig correction (TextBlob when installed,
   else the native corrector in utils/spelling.py — same algorithm over a
   domain-weighted corpus), then the HF text2text model pass, which stays
   gated offline (a learned seq2seq with no local substitute);
5. lowercase.

A built-in default mapping covers the common SUNRGBD concatenations; pass
``mapping_csv`` to use the dataset's own file when present.
"""

from __future__ import annotations

import functools
import re
from typing import Dict, Optional

import pandas as pd

from ...utils.numwords import num2words

# Most frequent concatenations in SUNRGBD annotations (subset of the
# reference's combined_words_mapping.csv, which is not committed there).
DEFAULT_COMBINED_WORDS: Dict[str, str] = {
    "nightstand": "night stand",
    "garbagebin": "garbage bin",
    "sidetable": "side table",
    "coffeetable": "coffee table",
    "endtable": "end table",
    "diningtable": "dining table",
    "bookshelf": "book shelf",
    "whiteboard": "white board",
    "bulletinboard": "bulletin board",
    "paperbox": "paper box",
}


def load_combined_words(mapping_csv: Optional[str] = None) -> Dict[str, str]:
    if mapping_csv:
        df = pd.read_csv(mapping_csv)
        return df.set_index("Combined Word").to_dict()["Separated Word"]
    return dict(DEFAULT_COMBINED_WORDS)


# Reference model for the learned spelling-correction stage
# (`post_process.py:7`); override via ``hf_model`` (e.g. a local
# save_pretrained directory — tests/test_creation.py exercises the full
# model stage with a tiny local seq2seq fixture).
HF_SPELL_MODEL = "oliverguhr/spelling-correction-english-base"


@functools.lru_cache(maxsize=4)
def _spell_fixers(hf_model: str = HF_SPELL_MODEL):
    """(word_corrector, hf_pipeline); hf may be None when unavailable.

    The word-level pass prefers TextBlob when installed (exact reference
    behavior) and otherwise uses the native Norvig corrector
    (utils/spelling.py) — same algorithm, domain-weighted corpus.  The HF
    text2text stage loads ``hf_model`` (reference: HF_SPELL_MODEL) from
    the local cache / path only — absent weights disable the stage rather
    than burning minutes of network retries offline.
    """
    tb = hf = None
    try:
        from textblob import Word

        tb = lambda w: str(Word(w).correct())  # noqa: E731
    except Exception:
        from ...utils.spelling import correct_word

        tb = correct_word
    try:
        import torch
        from transformers import pipeline

        hf = pipeline(
            "text2text-generation",
            model=hf_model,
            device=0 if torch.cuda.is_available() else -1,
            model_kwargs={"local_files_only": True},
        )
    except Exception:
        pass
    return tb, hf


def process_text_only(
    text: Optional[str],
    combined_words: Optional[Dict[str, str]] = None,
    enable_spellcheck: bool = True,
    hf_model: Optional[str] = None,
) -> str:
    """Reference pipeline order (`post_process.py:43-67`): combined-words
    split -> num2words -> strip trailing digits -> word spell-correct ->
    seq2seq model pass -> lowercase."""
    text = str(text) if text is not None else ""
    combined = combined_words or DEFAULT_COMBINED_WORDS

    for joined, fixed in combined.items():
        text = re.sub(rf"\b{joined}\b", fixed, text, flags=re.IGNORECASE)
    text = re.sub(r"\b\d+\b", lambda m: num2words(int(m.group())), text)
    text = re.sub(r"\b(\w+?)(\d+)\b", r"\1", text)

    if enable_spellcheck:
        tb, hf = _spell_fixers(hf_model or HF_SPELL_MODEL)
        if tb is not None:
            text = " ".join(tb(w) for w in text.split())
        if hf is not None:
            text = hf(text, max_length=20)[0]["generated_text"].rstrip(".")

    return text.lower()


def process_answers_column(
    df: pd.DataFrame,
    combined_words: Optional[Dict[str, str]] = None,
) -> pd.DataFrame:
    """`post_process.py:15-38` (column variant — no spellcheck there)."""
    combined = combined_words or DEFAULT_COMBINED_WORDS

    def process(text):
        text = str(text) if text is not None else ""
        for joined, fixed in combined.items():
            text = re.sub(rf"\b{joined}\b", fixed, text, flags=re.IGNORECASE)
        text = re.sub(r"\b\d+\b", lambda m: num2words(int(m.group())), text)
        text = re.sub(r"\b(\w+?)(\d+)\b", r"\1", text)
        return text.lower()

    df["Answers"] = df["Answers"].apply(process)
    return df


def clean_and_dedupe(values) -> list:
    """`dataset/utils.py:58-76`-style cleanup of the unique-items list."""
    out = []
    seen = set()
    for v in values:
        if v is None or (isinstance(v, float) and v != v):
            continue
        s = str(v).strip().lower()
        if s and s not in seen:
            seen.add(s)
            out.append(s)
    return out
