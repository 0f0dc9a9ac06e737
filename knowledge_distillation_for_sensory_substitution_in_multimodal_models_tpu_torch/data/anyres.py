"""Host-side anyres geometry: best-resolution selection, tile grids, image
token counts, and the static-shape *pack spec*.

The port's copy of the JAX package's ``data/anyres.py``.

TPU-first design note.  The reference (via HF
``LlavaOnevisionModel.pack_image_features``, see
`modeling_llava_onevision.py` in transformers) performs data-dependent
unpadding + bilinear interpolation of vision features *inside* the model —
incompatible with one statically-shaped XLA program.  Every one of those
decisions depends ONLY on the original image size, so this module hoists
them to the host as cheap integer math and emits, per image, a fixed-length
gather spec (4 source indices + 4 bilinear weights per packed token).  The
device-side pack is then a single static gather/weighted-sum, identical in
value to the HF semantics (verified in tests/test_model_parity.py).

Source bank layout for an image with ``max_tiles`` padded tiles, each
producing ``tp = tokens_per_side**2`` projected features:
``bank = concat(tile_features.reshape(max_tiles*tp, D), image_newline[None])``
so flat index ``tile*tp + within`` addresses a grid feature and index
``max_tiles*tp`` addresses the newline embedding.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import numpy as np


def select_best_resolution(
    original_size: Tuple[int, int], possible_resolutions: Sequence[Tuple[int, int]]
) -> Tuple[int, int]:
    """Pick the pinpoint (h, w) maximizing effective resolution then
    minimizing waste (HF ``select_best_resolution`` semantics)."""
    oh, ow = original_size
    best_fit = None
    max_effective = 0
    min_wasted = float("inf")
    for h, w in possible_resolutions:
        scale = min(w / ow, h / oh)
        dw, dh = int(ow * scale), int(oh * scale)
        effective = min(dw * dh, ow * oh)
        wasted = (w * h) - effective
        if effective > max_effective or (
            effective == max_effective and wasted < min_wasted
        ):
            max_effective = effective
            min_wasted = wasted
            best_fit = (h, w)
    return best_fit


def anyres_grid_shape(
    original_size: Tuple[int, int],
    pinpoints: Sequence[Tuple[int, int]],
    base_size: int,
) -> Tuple[int, int]:
    """(num_patch_height, num_patch_width) of the chosen pinpoint."""
    bh, bw = select_best_resolution(original_size, pinpoints)
    return bh // base_size, bw // base_size


def num_tiles(
    original_size: Tuple[int, int],
    pinpoints: Sequence[Tuple[int, int]],
    base_size: int,
) -> int:
    """Tiles incl. the base tile (HF ``image_size_to_num_patches``)."""
    nph, npw = anyres_grid_shape(original_size, pinpoints, base_size)
    return nph * npw + 1


def _unpadded_grid(
    orig_h: int, orig_w: int, grid_h: int, grid_w: int
) -> Tuple[int, int, int, int]:
    """Feature-grid unpadding (HF ``unpad_image``): returns
    (uh, uw, pad_top, pad_left) where the kept region is
    rows [pad_top, pad_top+uh) x cols [pad_left, pad_left+uw)."""
    original_ar = orig_w / orig_h
    current_ar = grid_w / grid_h
    if original_ar > current_ar:
        scale = grid_w / orig_w
        new_h = int(round(orig_h * scale, 7))
        pad = (grid_h - new_h) // 2
        return grid_h - 2 * pad, grid_w, pad, 0
    else:
        scale = grid_h / orig_h
        new_w = int(round(orig_w * scale, 7))
        pad = (grid_w - new_w) // 2
        return grid_h, grid_w - 2 * pad, 0, pad


def packed_grid_size(
    orig_h: int,
    orig_w: int,
    nph: int,
    npw: int,
    tokens_per_side: int,
    max_patches: int,
) -> Tuple[int, int, int, int, int, int]:
    """Final packed grid (h2, w2) plus unpad geometry (uh, uw, pad_t, pad_l).

    Mirrors the ratio>1.1 downsampling gate of ``pack_image_features`` /
    ``_get_unpadded_features``.
    """
    ts = tokens_per_side
    grid_h, grid_w = nph * ts, npw * ts
    uh, uw, pad_t, pad_l = _unpadded_grid(orig_h, orig_w, grid_h, grid_w)
    ratio = math.sqrt(uh * uw / (max_patches * ts**2))
    if ratio > 1.1:
        h2, w2 = int(uh // ratio), int(uw // ratio)
    else:
        h2, w2 = uh, uw
    return h2, w2, uh, uw, pad_t, pad_l


def num_image_tokens(
    original_size: Tuple[int, int],
    pinpoints: Sequence[Tuple[int, int]],
    base_size: int,
    tokens_per_side: int,
    max_patches: int,
) -> int:
    """Number of <image> placeholder tokens the processor must insert.

    Equals the HF processor's ``_get_number_of_features`` for
    vision_feature_select_strategy="full".
    """
    ts = tokens_per_side
    nph, npw = anyres_grid_shape(original_size, pinpoints, base_size)
    if nph * npw <= 1:
        # single-tile fallback never occurs with standard pinpoints (min is
        # 1x1 -> still goes through the anyres path with a 1x1 grid)
        pass
    h2, w2, *_ = packed_grid_size(
        original_size[0], original_size[1], nph, npw, ts, max_patches
    )
    base = ts * ts
    return base + h2 * (w2 + 1)


def constrained_grid(
    original_size: Tuple[int, int],
    pinpoints: Sequence[Tuple[int, int]],
    base_size: int,
    max_tiles: int,
) -> Tuple[int, int]:
    """(nph, npw) after applying the static tile budget.

    When the best pinpoint would exceed ``max_tiles`` (incl. the base tile),
    re-select among pinpoints that fit.  Used by BOTH the pack-spec builder
    and the image preprocessor so device-side features and host-side tiles
    always agree.
    """
    nph, npw = anyres_grid_shape(original_size, pinpoints, base_size)
    if nph * npw + 1 > max_tiles:
        allowed = [
            (h, w)
            for (h, w) in pinpoints
            if (h // base_size) * (w // base_size) + 1 <= max_tiles
        ]
        bh, bw = select_best_resolution(original_size, allowed)
        nph, npw = bh // base_size, bw // base_size
    return nph, npw


@dataclasses.dataclass
class PackSpec:
    """Static-shape gather spec for one image.

    idx/weight: [max_image_tokens, 4] into the source bank;
    valid: [max_image_tokens] bool; n_tokens: true token count;
    n_tiles: real tiles (incl. base) occupied in the padded tile axis.
    """

    idx: np.ndarray
    weight: np.ndarray
    valid: np.ndarray
    n_tokens: int
    n_tiles: int
    image_size: Tuple[int, int]


def build_pack_spec(
    original_size: Tuple[int, int],
    pinpoints: Sequence[Tuple[int, int]],
    base_size: int,
    tokens_per_side: int,
    max_patches: int,
    max_tiles: int,
    max_image_tokens: int,
) -> PackSpec:
    """Compute the gather/bilinear spec replicating HF pack_image_features.

    Token order: base tile (row-major ts*ts), then for each packed grid row
    r in [0,h2): w2 bilinear-sampled grid tokens then one newline token.
    """
    ts = tokens_per_side
    tp = ts * ts
    oh, ow = original_size
    nph, npw = constrained_grid(original_size, pinpoints, base_size, max_tiles)

    h2, w2, uh, uw, pad_t, pad_l = packed_grid_size(
        oh, ow, nph, npw, ts, max_patches
    )

    n_tokens = tp + h2 * (w2 + 1)
    if n_tokens > max_image_tokens:
        raise ValueError(
            f"pack spec needs {n_tokens} tokens > budget {max_image_tokens}"
        )

    idx = np.zeros((max_image_tokens, 4), dtype=np.int32)
    weight = np.zeros((max_image_tokens, 4), dtype=np.float32)
    valid = np.zeros((max_image_tokens,), dtype=bool)
    valid[:n_tokens] = True

    newline_idx = max_tiles * tp

    # --- base tile tokens (tile 0, identity gather) ---
    base_positions = np.arange(tp, dtype=np.int32)
    idx[:tp, 0] = base_positions  # tile 0 offset is 0
    weight[:tp, 0] = 1.0

    # --- grid tokens ---
    def full_grid_flat(gy: np.ndarray, gx: np.ndarray) -> np.ndarray:
        tile = 1 + (gy // ts) * npw + (gx // ts)
        within = (gy % ts) * ts + (gx % ts)
        return tile * tp + within

    out = tp
    if h2 == uh and w2 == uw:
        # No interpolation: direct gather from the unpadded region.
        for r in range(h2):
            gy = pad_t + r
            gx = pad_l + np.arange(w2)
            rows = np.full(w2, gy)
            idx[out : out + w2, 0] = full_grid_flat(rows, gx)
            weight[out : out + w2, 0] = 1.0
            out += w2
            idx[out, 0] = newline_idx
            weight[out, 0] = 1.0
            out += 1
    else:
        # torch F.interpolate(mode='bilinear', align_corners=False) on the
        # unpadded [uh, uw] region, sampled at [h2, w2].
        sy = uh / h2
        sx = uw / w2
        cols = np.arange(w2)
        x = (cols + 0.5) * sx - 0.5
        x0 = np.floor(x).astype(np.int64)
        wx1 = x - x0
        x0c = np.clip(x0, 0, uw - 1)
        x1c = np.clip(x0 + 1, 0, uw - 1)
        for r in range(h2):
            y = (r + 0.5) * sy - 0.5
            y0 = math.floor(y)
            wy1 = y - y0
            y0c = min(max(y0, 0), uh - 1)
            y1c = min(max(y0 + 1, 0), uh - 1)
            gy0 = pad_t + y0c
            gy1 = pad_t + y1c
            gx0 = pad_l + x0c
            gx1 = pad_l + x1c
            sl = slice(out, out + w2)
            idx[sl, 0] = full_grid_flat(np.full(w2, gy0), gx0)
            idx[sl, 1] = full_grid_flat(np.full(w2, gy0), gx1)
            idx[sl, 2] = full_grid_flat(np.full(w2, gy1), gx0)
            idx[sl, 3] = full_grid_flat(np.full(w2, gy1), gx1)
            weight[sl, 0] = (1 - wy1) * (1 - wx1)
            weight[sl, 1] = (1 - wy1) * wx1
            weight[sl, 2] = wy1 * (1 - wx1)
            weight[sl, 3] = wy1 * wx1
            out += w2
            idx[out, 0] = newline_idx
            weight[out, 0] = 1.0
            out += 1

    assert out == n_tokens, (out, n_tokens)
    return PackSpec(
        idx=idx,
        weight=weight,
        valid=valid,
        n_tokens=n_tokens,
        n_tiles=nph * npw + 1,
        image_size=(oh, ow),
    )


def stack_pack_specs(specs: List[PackSpec]):
    """Batch pack specs into arrays: idx [B,M,4], weight [B,M,4], valid [B,M]."""
    return (
        np.stack([s.idx for s in specs]),
        np.stack([s.weight for s in specs]),
        np.stack([s.valid for s in specs]),
    )
