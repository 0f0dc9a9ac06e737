"""Polygon geometry (shapely replacement).

The port's copy of the JAX package's ``data/creation/geometry.py``, which
imports no jax (``tests/test_torch_creation.py`` holds it to the original).

The reference uses ``shapely.geometry.Polygon(...).area``
(`dataset/utils.py:11-16`) and a hand-rolled vertex-mean centroid
(`direction_questions.py:25-28`); both are simple closed-form formulas.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def polygon_area(points: Sequence[Tuple[float, float]]) -> float:
    """Shoelace area; 0 for <4 points (reference
    `calculate_bounding_box_area`, `dataset/utils.py:11-16`, which also
    returns 0 below 4 points — shapely needs 4 incl. implicit closure)."""
    if len(points) < 4:
        return 0.0
    pts = np.asarray(points, dtype=np.float64)
    x, y = pts[:, 0], pts[:, 1]
    return float(abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))) / 2.0)


def centroid(points: Sequence[Tuple[float, float]]) -> Tuple[float, float]:
    """Vertex mean (`direction_questions.py:25-28` find_center_of_mass)."""
    pts = np.asarray(points, dtype=np.float64)
    return float(pts[:, 0].mean()), float(pts[:, 1].mean())


def create_polygon_points(x, y) -> List[Tuple[float, float]]:
    """Reference `utils.py:42-55` (root)."""
    if isinstance(x, int) and isinstance(y, int):
        return [(x, y)]
    if not isinstance(x, list):
        x = [x]
    if not isinstance(y, list):
        y = [y]
    return [(xi, yi) for xi, yi in zip(x, y)]


def is_number(n) -> bool:
    return isinstance(n, (int, float, complex))


def average_depth(poly: dict) -> float:
    """Mean Z of the polygon's XYZ samples; inf when absent/empty
    (`dataset/utils.py:20-34`)."""
    xyz = poly.get("XYZ")
    if not xyz:
        return float("inf")
    z = []
    for point in xyz:
        try:
            if is_number(point[2]):
                z.append(point[2])
        except Exception:
            continue
    return float(np.mean(z)) if z else float("nan")
