"""Number -> English words (num2words/inflect replacement, offline).

The port's copy of the JAX package's ``utils/numwords.py``.

The reference uses ``num2words`` in eval post-processing
(`evaluation/onevisionv3/evaluate_onevision.py:201-208`) and ``inflect`` in
the count-question generator (`dataset/dataset_creation/count_questions.py:38-96`);
neither package is available here, so this implements the same mapping
natively (standard US English, hyphenated tens, "and"-free — matching
``num2words`` output for the 0..999 range the datasets use... except
num2words uses "one hundred and one" British style?  num2words default lang
'en' produces "one hundred and one"; inflect produces "one hundred and
one" as well.  We follow that).
"""

from __future__ import annotations

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]


def num2words(n: int) -> str:
    """0..999999 -> words (num2words 'en' style, with 'and')."""
    if n < 0:
        return "minus " + num2words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        tens, ones = divmod(n, 10)
        return _TENS[tens] + (f"-{_ONES[ones]}" if ones else "")
    if n < 1000:
        hundreds, rest = divmod(n, 100)
        out = f"{_ONES[hundreds]} hundred"
        if rest:
            out += f" and {num2words(rest)}"
        return out
    thousands, rest = divmod(n, 1000)
    out = f"{num2words(thousands)} thousand"
    if rest:
        joiner = " and " if rest < 100 else " "
        out += joiner + num2words(rest)
    return out


def digits_to_words(text: str) -> str:
    """Replace standalone integer tokens with words (eval post-processing,
    `evaluate_onevision.py:201-208`)."""
    import re

    def repl(m):
        return num2words(int(m.group(0)))

    return re.sub(r"\b\d+\b", repl, text)
