"""Tokenization with image-token expansion.

The port's copy of the JAX package's ``data/tokenization.py``.

Two backends behind one interface:

* :class:`HFTokenizer` — wraps a local HF Qwen2 tokenizer snapshot
  (``AutoTokenizer.from_pretrained(path)``); required for real-checkpoint
  parity.  This environment has no network egress and no cached snapshot,
  so it activates only when the user supplies ``--tokenizer_path``.
* :class:`HashTokenizer` — deterministic offline fallback: regex word/punct
  split, ids = stable hash into the non-special vocab range.  Not
  reversible to the true Qwen2 ids, but preserves every structural property
  the pipeline needs (special tokens, stable ids, round-trip of the
  template) for development and tests.

Image expansion mirrors the HF processor: the single ``<image>``
placeholder in the rendered chat text is replaced by ``n_image_tokens``
copies of ``image_token_id`` (`anyres.num_image_tokens` drives n).
"""

from __future__ import annotations

import hashlib
import re
from typing import List, Optional, Protocol

from .chat import IMAGE_PLACEHOLDER


class Tokenizer(Protocol):
    pad_token_id: int
    eos_token_id: int
    image_token_id: int

    def encode(self, text: str) -> List[int]: ...
    def decode(self, ids: List[int]) -> str: ...


class HashTokenizer:
    """Offline word-level tokenizer with Qwen2-compatible special ids."""

    SPECIALS = {
        "<|im_start|>": 151644,
        "<|im_end|>": 151645,
        "<image>": 151646,
        "<video>": 151647,
    }
    _SPLIT = re.compile(r"(<\|im_start\|>|<\|im_end\|>|<image>|<video>|\n| |[^\s<]+)")

    def __init__(
        self,
        vocab_size: int = 151936,
        pad_token_id: int = 151645,
        eos_token_id: int = 151645,
        image_token_id: int = 151646,
    ):
        self.vocab_size = vocab_size
        self.pad_token_id = pad_token_id
        self.eos_token_id = eos_token_id
        self.image_token_id = image_token_id
        self._cache = {}
        self._rev = {}

    def _word_id(self, w: str) -> int:
        if w in self.SPECIALS:
            return self.SPECIALS[w]
        wid = self._cache.get(w)
        if wid is None:
            h = int.from_bytes(hashlib.sha1(w.encode()).digest()[:4], "big")
            wid = h % 151_000  # below all special ids
            self._cache[w] = wid
            self._rev.setdefault(wid, w)
        return wid

    def encode(self, text: str) -> List[int]:
        return [self._word_id(t) for t in self._SPLIT.findall(text)]

    def decode(self, ids) -> str:
        inv = {v: k for k, v in self.SPECIALS.items()}
        out = []
        for i in ids:
            i = int(i)
            out.append(inv.get(i) or self._rev.get(i, f"<{i}>"))
        return "".join(
            t if t in ("\n", " ") or t.startswith("<") else t + " " for t in out
        ).strip()


class HFTokenizer:
    """Local HF tokenizer snapshot (Qwen2-tokenizer for OneVision; the
    reference always loads the 7B repo's processor, `phase1/train_online_kd.py:76-78`)."""

    def __init__(self, path: str, image_token_id: int = 151646):
        from transformers import AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        if self.tok.pad_token_id is None:
            # pad -> eos fallback, as everywhere in the reference
            # (`LLavaOneVisionModule.py:24-26`)
            self.tok.pad_token = self.tok.eos_token
        self.pad_token_id = self.tok.pad_token_id
        self.eos_token_id = self.tok.eos_token_id
        self.image_token_id = image_token_id

    def encode(self, text: str) -> List[int]:
        return self.tok(text, add_special_tokens=False)["input_ids"]

    def decode(self, ids) -> str:
        return self.tok.decode(ids, skip_special_tokens=False)

    # When the local snapshot bundles the model's own chat template, use it
    # verbatim (exact whitespace parity with the reference's
    # ``processor.apply_chat_template``); the collator falls back to
    # ``data.chat`` renders otherwise.
    def render_train(self, question: str, answer: str) -> Optional[str]:
        if not getattr(self.tok, "chat_template", None):
            return None
        conversation = [
            {"role": "user", "content": [
                {"type": "text", "text": question}, {"type": "image"},
            ]},
            {"role": "assistant", "content": [{"type": "text", "text": answer}]},
        ]
        return self.tok.apply_chat_template(conversation, tokenize=False)

    def render_eval(self, question: str, one_word_suffix: bool = True) -> Optional[str]:
        if not getattr(self.tok, "chat_template", None):
            return None
        q = question + " Answer in one word if possible." if one_word_suffix else question
        conversation = [
            {"role": "user", "content": [
                {"type": "text", "text": q}, {"type": "image"},
            ]},
        ]
        return self.tok.apply_chat_template(
            conversation, tokenize=False, add_generation_prompt=True
        )


def get_tokenizer(path: Optional[str] = None) -> Tokenizer:
    return HFTokenizer(path) if path else HashTokenizer()


def encode_with_image(
    tokenizer: Tokenizer, text: str, n_image_tokens: int
) -> List[int]:
    """Tokenize, expanding the single <image> placeholder to n copies of
    image_token_id (HF processor expansion semantics)."""
    if IMAGE_PLACEHOLDER not in text:
        return list(tokenizer.encode(text))
    pre, post = text.split(IMAGE_PLACEHOLDER, 1)
    return (
        list(tokenizer.encode(pre))
        + [tokenizer.image_token_id] * n_image_tokens
        + list(tokenizer.encode(post))
    )
