"""LLaVA-OneVision's anyres geometry, as HF transformers computes it
(``select_best_resolution``, ``get_anyres_image_grid_shape``,
``unpad_image`` and the processor's ``_get_number_of_features`` for
``vision_aspect_ratio = "anyres_max_N"``); sizes are (height, width)."""

from __future__ import annotations

import math
from typing import Sequence, Tuple


def select_best_resolution(size: Tuple[int, int], pinpoints: Sequence[Sequence[int]]) -> Tuple[int, int]:
    oh, ow = size
    best, best_eff, best_waste = None, 0, float("inf")
    for h, w in pinpoints:
        scale = min(w / ow, h / oh)
        eff = min(int(ow * scale) * int(oh * scale), ow * oh)
        waste = w * h - eff
        if eff > best_eff or (eff == best_eff and waste < best_waste):
            best, best_eff, best_waste = (h, w), eff, waste
    return best


def grid_shape(size, pinpoints, tile: int) -> Tuple[int, int]:
    """(tiles down, tiles across) of the chosen resolution."""
    h, w = select_best_resolution(size, pinpoints)
    return h // tile, w // tile


def num_tiles(size, pinpoints, tile: int) -> int:
    """Tiles the processor makes: the base tile and the grid."""
    nph, npw = grid_shape(size, pinpoints, tile)
    return nph * npw + 1


def unpad_rows_cols(size, rows: int, cols: int) -> Tuple[int, int, int, int]:
    """HF ``unpad_image`` on a [rows, cols] feature grid: (first row, rows,
    first col, cols) kept."""
    oh, ow = size
    if ow / oh > cols / rows:
        new_h = int(round(oh * (cols / ow), 7))
        pad = (rows - new_h) // 2
        return pad, rows - 2 * pad, 0, cols
    new_w = int(round(ow * (rows / oh), 7))
    pad = (cols - new_w) // 2
    return 0, rows, pad, cols - 2 * pad


def packed_grid(size, pinpoints, tile: int, side: int, max_patches: int) -> Tuple[int, int, bool]:
    """(rows, cols, interpolated) of the grid features after unpadding and
    the anyres_max downsampling (``ratio > 1.1``)."""
    nph, npw = grid_shape(size, pinpoints, tile)
    _, rows, _, cols = unpad_rows_cols(size, nph * side, npw * side)
    ratio = math.sqrt(rows * cols / (max_patches * side**2))
    if ratio > 1.1:
        return int(rows // ratio), int(cols // ratio), True
    return rows, cols, False


def num_image_tokens(size, pinpoints, tile: int, side: int, max_patches: int) -> int:
    """Image placeholder tokens: the base tile's features, then each grid
    row's features and a newline."""
    rows, cols, _ = packed_grid(size, pinpoints, tile, side, max_patches)
    return side * side + rows * (cols + 1)


def max_patches(model: dict) -> int:
    return int(model["vision_aspect_ratio"].removeprefix("anyres_max_"))
