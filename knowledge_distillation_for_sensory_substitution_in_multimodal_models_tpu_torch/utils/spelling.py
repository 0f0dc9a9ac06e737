"""Native frequency-based spell corrector (Norvig algorithm).

The port's copy of the JAX package's ``utils/spelling.py``, which imports no
jax (``tests/test_torch_creation.py`` holds it to the original).

The reference's answer post-processing runs TextBlob's ``Word.correct()``
(`dataset/dataset_creation/post_process.py:57`), which is exactly Peter
Norvig's classic corrector: generate all candidates within edit distance
1 (then 2) of the word and pick the one with the highest corpus
frequency.  TextBlob isn't installable offline, so this module implements
the same algorithm natively over a built-in frequency list weighted for
the SUNRGBD VQA domain (object names, colors, counts, directions) on top
of high-frequency English words.

Divergence note: TextBlob scores against the general-English ``pattern``
corpus; on open-domain text the chosen candidate can differ.  On the
dataset's own vocabulary — the only text this pipeline sees — the
domain list dominates and corrections match the intent (golden tests in
tests/test_creation.py pin the behavior).
"""

from __future__ import annotations

import functools
import re
from typing import Dict, Iterable, Optional, Set

_ALPHABET = "abcdefghijklmnopqrstuvwxyz"

# Domain vocabulary (SUNRGBD object names from the annotation corpus, the
# question templates' color/count/direction/yes-no answer space) gets a
# high count so in-domain typos resolve to in-domain words; the general
# tier breaks ties for function words inside full-sentence answers.
_DOMAIN_WORDS = """
chair table desk bed sofa couch lamp pillow cushion shelf shelves cabinet
drawer dresser nightstand stand monitor keyboard mouse computer laptop
printer screen television tv door window curtain blinds wall floor ceiling
rug carpet mat picture painting frame mirror clock vase plant pot flower
book books bookshelf paper papers box boxes bag basket bin garbage trash
bottle cup mug glass bowl plate sink faucet counter countertop stove oven
microwave refrigerator fridge kettle toaster towel blanket sheet mattress
headboard bench stool ottoman recliner armchair wardrobe closet hanger
toilet bathtub shower urinal tissue dispenser whiteboard blackboard board
bulletin projector podium speaker telephone phone fan heater radiator
vent switch outlet socket ladder cart tray rack hook shelf organizer
divider partition railing column pillar beam stairs staircase
backpack suitcase luggage purse jacket coat clothes clothing shoe shoes
person people man woman child baby toy doll ball
red orange yellow green blue purple pink brown black white gray grey
beige tan cream silver gold dark light
one two three four five six seven eight nine ten eleven twelve thirteen
fourteen fifteen sixteen seventeen eighteen nineteen twenty zero
left right above under below behind front back near far close closest
farthest nearest next beside between middle center corner top bottom
yes no
night side end coffee dining bedside office living room bedroom kitchen
bathroom classroom hallway
""".split()

_GENERAL_WORDS = """
the a an is are was were be been being of in on at to from by with
without and or not it its this that these those there here what which
who whom whose where when why how i you he she we they them his her
their our your my me him us do does did done have has had having can
could will would shall should may might must most more less many much
few little large small big tiny huge long short tall wide narrow thick
thin new old same different other another object objects item items
thing things image picture scene area place spot located location
visible present color colour shape size number count closest most
prominent main
""".split()


@functools.lru_cache(maxsize=1)
def default_word_freq() -> Dict[str, int]:
    freq: Dict[str, int] = {}
    for w in _GENERAL_WORDS:
        freq[w] = max(freq.get(w, 0), 10)
    for w in _DOMAIN_WORDS:
        freq[w] = max(freq.get(w, 0), 100)
        # regular plurals, slightly below the singular so exact singular
        # typos still prefer the singular
        if not w.endswith("s"):
            plural = w + ("es" if w[-1] in "sxz" or w.endswith(("ch", "sh"))
                          else "s")
            freq[plural] = max(freq.get(plural, 0), 80)
    return freq


def _edits1(word: str) -> Set[str]:
    splits = [(word[:i], word[i:]) for i in range(len(word) + 1)]
    deletes = {L + R[1:] for L, R in splits if R}
    transposes = {L + R[1] + R[0] + R[2:] for L, R in splits if len(R) > 1}
    replaces = {L + c + R[1:] for L, R in splits if R for c in _ALPHABET}
    inserts = {L + c + R for L, R in splits for c in _ALPHABET}
    return deletes | transposes | replaces | inserts


def correct_word(word: str, freq: Optional[Dict[str, int]] = None) -> str:
    """Best-frequency candidate at edit distance 0, 1, then 2 (Norvig).

    Non-alphabetic tokens and words already in the corpus pass through.
    Case-insensitive; returns lowercase for corrected words (the pipeline
    lowercases afterwards regardless, matching `post_process.py:66`).
    """
    if not word or not word.isalpha():
        return word
    f = freq if freq is not None else default_word_freq()
    lw = word.lower()
    if lw in f:
        return word

    def known(cands: Iterable[str]) -> list:
        return [c for c in cands if c in f]

    e1 = _edits1(lw)
    candidates = known(e1)
    if not candidates:
        candidates = known(c2 for c1 in e1 for c2 in _edits1(c1))
    if not candidates:
        return word
    # deterministic: frequency desc, then lexicographic
    return max(sorted(candidates), key=lambda c: f[c])


def correct_text(text: str, freq: Optional[Dict[str, int]] = None) -> str:
    """Word-by-word correction preserving whitespace-separated structure
    (the reference's ``" ".join(Word(w).correct() for w in text.split())``,
    `post_process.py:57`)."""
    out = []
    for token in text.split():
        # strip trivial punctuation the way TextBlob's Word coerces input
        m = re.match(r"^(\W*)(\w*)(\W*)$", token)
        if m and m.group(2):
            out.append(m.group(1) + correct_word(m.group(2), freq) + m.group(3))
        else:
            out.append(token)
    return " ".join(out)
