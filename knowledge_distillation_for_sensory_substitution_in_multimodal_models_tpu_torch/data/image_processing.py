"""Native anyres image preprocessing (the port's copy of the JAX package's
``data/image_processing.py``) (HF LlavaOnevisionImageProcessor
equivalent, no transformers dependency at runtime).

Replicates, for each image (parity-tested against HF in
tests/test_image_processing.py):

1. best-resolution selection over ``image_grid_pinpoints``;
2. aspect-preserving bicubic resize into the best resolution
   (HF ``_resize_for_patching`` / ``get_patch_output_size``);
3. centered zero-pad to the best resolution (``_pad_for_patching``);
4. row-major division into ``base_size`` tiles (``divide_to_patches``);
5. the base tile: direct (non-aspect-preserving) resize to
   (base_size, base_size);
6. rescale 1/255 + normalize (mean=std=0.5, the SigLIP convention).

Output is NHWC float32 padded to the static ``max_tiles`` budget, with the
grid constrained by :func:`..data.anyres.constrained_grid` so the tile
layout always matches the device-side pack spec.

Reference context: the reference calls the HF processor twice per batch
(once depth, once RGB) inside ``collate_fn``
(`dataset/datamodule/OneVision/CustomSUNRGBDOneVisionDataModule.py:127-143`).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import math

import numpy as np

from ..configs import LlavaOnevisionConfig
from .anyres import constrained_grid


def _patch_output_size(
    orig_h: int, orig_w: int, target_h: int, target_w: int
) -> Tuple[int, int]:
    """HF ``get_patch_output_size``: fit inside target, ceil + clamp."""
    scale_w = target_w / orig_w
    scale_h = target_h / orig_h
    if scale_w < scale_h:
        new_w = target_w
        new_h = min(math.ceil(orig_h * scale_w), target_h)
    else:
        new_h = target_h
        new_w = min(math.ceil(orig_w * scale_h), target_w)
    return new_h, new_w


def _resize(img: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """PIL bicubic resize, uint8 HWC in/out (HF uses PIL under the hood)."""
    from PIL import Image  # imported here: the module loads without PIL

    pil = Image.fromarray(img)
    return np.asarray(pil.resize((size_hw[1], size_hw[0]), Image.BICUBIC))


def process_anyres_image(
    image: np.ndarray,
    cfg: LlavaOnevisionConfig,
) -> Tuple[np.ndarray, int]:
    """uint8 [H, W, 3] -> (tiles [max_tiles, S, S, 3] float32, n_tiles).

    Tile order: base tile first, then grid tiles row-major — identical to
    HF ``get_image_patches`` ([resized_original] + patches).
    """
    assert image.dtype == np.uint8 and image.ndim == 3, (image.dtype, image.shape)
    base = cfg.vision.image_size
    oh, ow = image.shape[:2]
    nph, npw = constrained_grid((oh, ow), cfg.image_grid_pinpoints, base, cfg.max_tiles)
    best_h, best_w = nph * base, npw * base

    # aspect-preserving resize + centered pad
    new_h, new_w = _patch_output_size(oh, ow, best_h, best_w)
    resized = _resize(image, (new_h, new_w))
    pad_y, r_y = divmod(best_h - new_h, 2)
    pad_x, r_x = divmod(best_w - new_w, 2)
    padded = np.zeros((best_h, best_w, 3), dtype=np.uint8)
    padded[pad_y : pad_y + new_h, pad_x : pad_x + new_w] = resized

    n_tiles = nph * npw + 1
    out = np.zeros((cfg.max_tiles, base, base, 3), dtype=np.float32)

    def norm(u8: np.ndarray) -> np.ndarray:
        # rescale 1/255 then (x - 0.5) / 0.5
        return (u8.astype(np.float32) / 255.0 - 0.5) / 0.5

    out[0] = norm(_resize(image, (base, base)))
    t = 1
    for gy in range(nph):
        for gx in range(npw):
            tile = padded[gy * base : (gy + 1) * base, gx * base : (gx + 1) * base]
            out[t] = norm(tile)
            t += 1
    assert t == n_tiles
    return out, n_tiles


def process_anyres_batch(
    images: Sequence[np.ndarray], cfg: LlavaOnevisionConfig
) -> Tuple[np.ndarray, np.ndarray]:
    """List of uint8 HWC images -> (pixels [B, max_tiles, S, S, 3],
    tile_valid [B, max_tiles] bool)."""
    b = len(images)
    base = cfg.vision.image_size
    pixels = np.zeros((b, cfg.max_tiles, base, base, 3), dtype=np.float32)
    tile_valid = np.zeros((b, cfg.max_tiles), dtype=bool)
    for i, img in enumerate(images):
        tiles, n = process_anyres_image(img, cfg)
        pixels[i] = tiles
        tile_valid[i, :n] = True
    return pixels, tile_valid
