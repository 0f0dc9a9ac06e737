"""Local color-VQA backends for the color question generator.

The port's copy of the JAX package's ``data/creation/color_backend.py``,
which imports no jax (``tests/test_torch_creation.py`` holds it to the
original); its student backend reaches the port's ``eval/runner.py``.

The reference answers "What is the color of the {object}?" by shelling
into BLIP-VQA per image (`dataset/dataset_creation/color_questions.py:151-181`).
That model cannot be downloaded offline, so this module provides:

* :func:`heuristic_color_vqa` — the always-available default: a
  deterministic dominant-color classifier over the prominent object's
  pixel region (median RGB of the polygon's bounding box, snapped to a
  named-color table with saturation/lightness rules for the achromatic
  axis).  Unlike BLIP it looks at exactly the object being asked about,
  so its answers are grounded by construction.
* :func:`make_blip_color_vqa` — the reference's backend, used when a
  local BLIP snapshot is available (exact parity path).
* :func:`make_student_color_vqa` — routes the question through a
  converted OneVision student checkpoint via the framework's own
  generator (the "model-in-the-loop" spirit with no external model).

All backends share the signature ``fn(image, question, crop=None) ->
answer``; the generator passes the prominent object's bbox crop so
region-aware backends can use it and image-level models can ignore it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# Named colors in the answer vocabulary BLIP typically emits for this
# dataset (basic CSS-ish anchors).
_COLOR_ANCHORS = {
    "red": (200, 40, 40),
    "orange": (230, 140, 40),
    "yellow": (220, 210, 60),
    "green": (70, 160, 70),
    "blue": (60, 90, 190),
    "purple": (130, 70, 160),
    "pink": (230, 150, 170),
    "brown": (120, 80, 50),
    "beige": (210, 190, 160),
}


def _rgb_to_hsl_parts(rgb: np.ndarray):
    r, g, b = (float(x) / 255.0 for x in rgb)
    mx, mn = max(r, g, b), min(r, g, b)
    light = (mx + mn) / 2.0
    sat = 0.0 if mx == mn else (mx - mn) / (1.0 - abs(2.0 * light - 1.0))
    return sat, light


def classify_rgb(rgb: np.ndarray) -> str:
    """Snap one RGB triple to a color name (achromatic rules first)."""
    sat, light = _rgb_to_hsl_parts(rgb)
    if light >= 0.85:
        return "white"
    if light <= 0.13:
        return "black"
    if sat < 0.12:
        return "gray"
    r, g, b = (float(x) for x in rgb)
    best, best_d = "gray", float("inf")
    for name, (ar, ag, ab) in _COLOR_ANCHORS.items():
        # perception-weighted RGB distance (red/blue downweighted vs green)
        d = 2 * (r - ar) ** 2 + 4 * (g - ag) ** 2 + 3 * (b - ab) ** 2
        if d < best_d:
            best, best_d = name, d
    return best


def heuristic_color_vqa(image, question: str, crop=None) -> Optional[str]:
    """Dominant color of the object region (or whole image as fallback).

    Median per channel is robust to highlights/shadows; a ~64x64
    downsample bounds the cost per image.
    """
    region = crop if crop is not None and getattr(crop, "size", 0) else image
    arr = np.asarray(region)
    if arr.ndim != 3 or arr.shape[-1] < 3 or arr.size == 0:
        return None
    h, w = arr.shape[:2]
    step_h, step_w = max(1, h // 64), max(1, w // 64)
    sample = arr[::step_h, ::step_w, :3].reshape(-1, 3)
    med = np.median(sample, axis=0)
    return classify_rgb(med)


def make_blip_color_vqa(path: str):
    """The reference's BLIP-VQA backend (`color_questions.py:151-181`),
    from a local snapshot."""
    from PIL import Image
    from transformers import BlipForQuestionAnswering, BlipProcessor

    processor = BlipProcessor.from_pretrained(path, local_files_only=True)
    model = BlipForQuestionAnswering.from_pretrained(
        path, local_files_only=True
    )

    def vqa(image, question, crop=None):
        inputs = processor(
            Image.fromarray(np.asarray(image)), question, return_tensors="pt"
        )
        out = model.generate(**inputs, max_new_tokens=10)
        return processor.decode(out[0], skip_special_tokens=True)

    return vqa


def make_student_color_vqa(checkpoint_dir: str, processor_path: str):
    """Answer color questions with the converted OneVision student via the
    framework's own jit generator (cli/inference.py machinery)."""
    from ...eval.runner import load_student_for_eval  # lazy heavy imports

    answer_fn = load_student_for_eval(checkpoint_dir, processor_path)

    def vqa(image, question, crop=None):
        return answer_fn(np.asarray(image), question)

    return vqa
