"""Question generators (reference `dataset/dataset_creation/*.py`), as pure
per-annotation functions returning row dicts
``{Questions, Answers, Question_Type}`` (IDs/paths added by ``cli/create_dataset.py``).

The port's copy of the JAX package's ``data/creation/questions.py``, which
imports no jax (``tests/test_torch_creation.py`` holds it to the original).

Parity map:
* object identification — "What is the most prominent object?" with
  floor<=500 / wall<=450 caps handled by the CLI's counters
  (`object_identification.py:193-298,242-252`);
* count — "How many {X}s are there?" for the prominent object, answer in
  words (`count_questions.py:38-96`);
* yes/no — positive for the prominent object + one random negative drawn
  from the unique-items list (`Yes_No_Questions.py:54-117`);
* proximity — closest/farthest by centroid distance from the prominent
  object, unwanted names dropped (`ProximityQuestion_new.py`);
* direction — angle from the prominent object's centroid to another
  object's, mapped to left/right/above/under (+ exact-axis special cases)
  (`direction_questions.py:30-107,249-250`);
* color — model-in-the-loop (BLIP-VQA in the reference,
  `color_questions.py:151-181,221`): takes a ``vqa_fn(image, question) ->
  answer`` callable so any local VQA backend can drive it.
"""

from __future__ import annotations

import math
import random
from collections import Counter
from typing import Callable, Dict, List, Optional

from .geometry import centroid
from .postprocess import process_text_only
from .prominent import (
    UNWANTED_NAMES,
    find_most_prominent_object,
    find_object_index,
    get_object_name_list,
)

Row = Dict[str, str]


def object_identification_row(
    annotation: dict, combined_words=None, enable_spellcheck=True
) -> Optional[Row]:
    name = find_most_prominent_object(annotation)
    if name is None:
        return None
    processed = process_text_only(
        name.lower(), combined_words, enable_spellcheck
    )
    if not processed or processed == "n/a":
        processed = "cannot answer"
    return {
        "Questions": "What is the most prominent object?",
        "Answers": processed,
        "Question_Type": "Object Identification",
    }


def count_row(
    annotation: dict, combined_words=None, enable_spellcheck=True
) -> Optional[Row]:
    from ...utils.numwords import num2words

    name = find_most_prominent_object(annotation)
    if name is None:
        return None
    processed = process_text_only(name, combined_words, enable_spellcheck)
    counts = Counter(
        process_text_only(n, combined_words, enable_spellcheck)
        for n in get_object_name_list(annotation)
    )
    count = counts[processed]
    return {
        "Questions": f"How many {processed}s are there?",
        "Answers": num2words(count),
        "Question_Type": "Count",
    }


def yes_no_rows(
    annotation: dict,
    unique_items: List[str],
    rng: random.Random,
    combined_words=None,
    enable_spellcheck=True,
) -> List[Row]:
    name = find_most_prominent_object(annotation)
    if name is None:
        return []
    processed = process_text_only(name, combined_words, enable_spellcheck)
    rows = [{
        "Questions": f"Is there any {processed}?",
        "Answers": "yes",
        "Question_Type": "Yes/No",
    }]
    negatives = [i for i in unique_items if i != processed]
    if negatives:
        rows.append({
            "Questions": f"Is there any {rng.choice(negatives)}?",
            "Answers": "no",
            "Question_Type": "Yes/No",
        })
    return rows


def _object_centroids(annotation: dict):
    """[(centroid, name, obj_idx)] for frame-0 polygons with wanted names.

    Identity is the object *index* (as in the reference's centroid dicts,
    `ProximityQuestion_new.py:243+`): a second same-named instance is a
    valid closest/farthest candidate.
    """
    out = []
    objects = annotation["objects"]
    for poly in annotation["frames"][0]["polygon"]:
        idx = poly["object"]
        if not (0 <= idx < len(objects)):
            continue
        obj = objects[idx]
        if not (isinstance(obj, dict) and "name" in obj):
            continue
        if any(u in obj["name"].lower() for u in UNWANTED_NAMES):
            continue
        points = [(x, y) for x, y in zip(poly["x"], poly["y"])]
        if not points:
            continue
        out.append((centroid(points), obj["name"], idx))
    return out


def proximity_rows(
    annotation: dict, combined_words=None, enable_spellcheck=True
) -> List[Row]:
    name = find_most_prominent_object(annotation)
    if name is None:
        return []
    prominent_idx = find_object_index(annotation, name)
    cents = _object_centroids(annotation)
    prominent = next((c for c, n, i in cents if i == prominent_idx), None)
    others = [(c, n) for c, n, i in cents if i != prominent_idx]
    if prominent is None or not others:
        return []

    def dist(c):
        return math.hypot(c[0] - prominent[0], c[1] - prominent[1])

    closest = min(others, key=lambda t: dist(t[0]))
    farthest = max(others, key=lambda t: dist(t[0]))
    p_name = process_text_only(name, combined_words, enable_spellcheck)
    return [
        {
            "Questions": f"What is closest to the {p_name}?",
            "Answers": process_text_only(closest[1], combined_words, enable_spellcheck),
            "Question_Type": "Proximity",
        },
        {
            "Questions": f"What is farthest to the {p_name}?",
            "Answers": process_text_only(farthest[1], combined_words, enable_spellcheck),
            "Question_Type": "Proximity",
        },
    ]


def _direction_label(angle: float) -> str:
    """`direction_questions.py:81-107`: exact-axis special cases, else
    'horizontal and vertical' composite."""
    horizontal = "left" if -math.pi / 2 < angle <= math.pi / 2 else "right"
    vertical = "above" if 0 < angle <= math.pi else "under"
    if math.isclose(angle, 0, abs_tol=1e-2):
        return "right"
    if math.isclose(abs(angle), math.pi, abs_tol=1e-2):
        return "left"
    if math.isclose(angle, math.pi / 2, abs_tol=1e-2):
        return "above"
    if math.isclose(angle, -math.pi / 2, abs_tol=1e-2):
        return "under"
    return f"{horizontal} and {vertical}"


def direction_row(
    annotation: dict, combined_words=None, enable_spellcheck=True
) -> Optional[Row]:
    name = find_most_prominent_object(annotation)
    if name is None:
        return None
    prominent_idx = find_object_index(annotation, name)
    cents = _object_centroids(annotation)
    prominent = next((c for c, n, i in cents if i == prominent_idx), None)
    others = [(c, n) for c, n, i in cents if i != prominent_idx]
    if prominent is None or not others:
        return None
    (cx, cy), other_name = others[0]
    # NOTE reference semantics: the direction vector points from the
    # prominent object to the other, but labels describe the *prominent*
    # object's position relative to the other (`direction_questions.py:134`).
    angle = math.atan2(cy - prominent[1], cx - prominent[0])
    p_name = process_text_only(name, combined_words, enable_spellcheck)
    o_name = process_text_only(other_name, combined_words, enable_spellcheck)
    return {
        "Questions": f"Where is {p_name} relative to {o_name}?",
        "Answers": _direction_label(angle),
        "Question_Type": "Direction",
    }


def _prominent_bbox_crop(annotation: dict, image, name: str):
    """Crop of the prominent object's polygon bbox (None if unavailable).

    Region-aware color backends (data/creation/color_backend.py) classify
    pixels of exactly the object being asked about; image-level models
    (BLIP, the student) ignore the crop.
    """
    try:
        import numpy as np

        from .prominent import find_object_polygon

        idx = find_object_index(annotation, name)
        if idx < 0:
            return None
        poly = find_object_polygon(annotation, idx)
        if not poly or not poly.get("x") or not poly.get("y"):
            return None
        arr = np.asarray(image)
        xs = [float(v) for v in poly["x"]]
        ys = [float(v) for v in poly["y"]]
        h, w = arr.shape[:2]
        x0, x1 = max(0, int(min(xs))), min(w, int(max(xs)) + 1)
        y0, y1 = max(0, int(min(ys))), min(h, int(max(ys)) + 1)
        if x1 - x0 < 2 or y1 - y0 < 2:
            return None
        return arr[y0:y1, x0:x1]
    except Exception:
        return None


def color_row(
    annotation: dict,
    image,
    vqa_fn: Callable[["object", str], str],
    combined_words=None,
    enable_spellcheck=True,
) -> Optional[Row]:
    """Model-in-the-loop color question: ``vqa_fn(image, question,
    crop=...)`` answers "What is the color of the {object}?" on the RGB
    image (the reference shells into BLIP-VQA here,
    `color_questions.py:151-181`); ``crop`` is the prominent object's bbox
    for region-aware local backends."""
    name = find_most_prominent_object(annotation)
    if name is None:
        return None
    p_name = process_text_only(name, combined_words, enable_spellcheck)
    question = f"What is the color of {p_name}?"
    crop = _prominent_bbox_crop(annotation, image, name)
    answer = vqa_fn(image, f"What is the color of the {p_name}?", crop=crop)
    if not answer:
        return None
    return {
        "Questions": question,
        "Answers": str(answer).lower().strip(),
        "Question_Type": "Color",
    }
