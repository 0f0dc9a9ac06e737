"""Qwen2 / LLaVA-OneVision chat template rendering.

The port's copy of the JAX package's ``data/chat.py``.

The reference renders prompts through the HF processor's bundled jinja
template (`CustomSUNRGBDOneVisionDataModule.py:106-123`), with content order
[question text, image] for training and the eval prompt built the same way
plus the suffix " Answer in one word if possible."
(`evaluation/onevisionv3/evaluate_onevision.py:163-177`).

The template of ``llava-hf/llava-onevision-qwen2-*-ov-hf``: each message is
``<|im_start|>{role} {content}<|im_end|>`` with ``<image>`` inline for image
content and ``\n`` appended after an image segment; the generation prompt is
``<|im_start|>assistant\n``.
"""

from __future__ import annotations

from typing import List, Tuple

IM_START = "<|im_start|>"
IM_END = "<|im_end|>"
IMAGE_PLACEHOLDER = "<image>"


def render_message(role: str, segments: List[Tuple[str, str]]) -> str:
    """segments: list of ("text", s) / ("image", "") in order."""
    parts = [IM_START, role, " "]
    for kind, text in segments:
        if kind == "text":
            parts.append(text)
        elif kind == "image":
            parts.append(IMAGE_PLACEHOLDER + "\n")
        else:
            raise ValueError(kind)
    parts.append(IM_END)
    return "".join(parts)


def render_train_prompt(question: str, answer: str) -> str:
    """user(question + image) -> assistant(answer), reference content order
    (`CustomSUNRGBDOneVisionDataModule.py:108-120`: text first, then image)."""
    return render_message("user", [("text", question), ("image", "")]) + render_message(
        "assistant", [("text", answer)]
    )


def render_pixtral_train_prompt(question: str, answer: str) -> str:
    """Mistral/Pixtral chat format (`dataset/datamodule/pixtral/
    CustomSUNRGBDPixtralDataModule.py:40-64`):
    ``<s>[INST] {q}[IMG][/INST] {a}</s>``."""
    return f"<s>[INST] {question}[IMG][/INST] {answer}</s>"


def render_pixtral_eval_prompt(question: str, one_word_suffix: bool = True) -> str:
    """Pixtral eval prompt (`evaluation/pixtral/evaluate_pixtral.py:190-198`)."""
    q = question + " Answer in one word if possible." if one_word_suffix else question
    return f"<s>[INST] {q}[IMG][/INST]"


def render_train_style_eval_prompt(question: str) -> str:
    """Generation prefix matching the TRAINING template byte-for-byte (the
    assistant header with its trailing space, no one-word suffix).

    NOT reference parity: the reference always evaluates with
    ``render_eval_prompt`` below.  In the training template ``\\n`` occurs
    only after the image segment and is always followed by ``<|im_end|>``,
    so a from-scratch model that has seen nothing but the training
    distribution deterministically emits ``<|im_end|>`` after the eval
    prompt's ``assistant\\n`` header.  The pretrained reference checkpoint
    bridges that shift; an offline-tokenizer overfit run cannot — the
    end-to-end learning test (tests/test_e2e_learning.py) uses this style
    via ``--prompt_style train``.
    """
    return (
        render_message("user", [("text", question), ("image", "")])
        + IM_START
        + "assistant "
    )


def render_eval_prompt(question: str, one_word_suffix: bool = True) -> str:
    """Generation prompt; eval appends the one-word instruction
    (`evaluate_onevision.py:163-177`)."""
    q = question + " Answer in one word if possible." if one_word_suffix else question
    return (
        render_message("user", [("text", q), ("image", "")])
        + IM_START
        + "assistant\n"
    )
