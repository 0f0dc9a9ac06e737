"""Synthetic dual-stream KD batches with real anyres geometry (the port's
copy of the JAX package's ``utils/synthetic.py``).

Used by the tests and ``chip_smoke.py`` to exercise the exact batch layout the data pipeline emits (SURVEY.md §2.3
"OneVision datamodule": {rgb,depth}_input_ids / pixel_values + labels)
without touching SUNRGBD data on disk.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..configs import LlavaOnevisionConfig
from ..data.anyres import build_pack_spec, num_tiles, stack_pack_specs


def synthetic_kd_batch(
    cfg: LlavaOnevisionConfig,
    batch_size: int = 1,
    seq_len: int = 64,
    orig_sizes: Optional[Sequence[Tuple[int, int]]] = None,
    accum: Optional[int] = None,
    seed: int = 0,
    text_vocab: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Build a statically-shaped dual-stream batch.

    Sequence layout per sample: 4 text tokens, the image-token block sized
    by the real pack spec for ``orig_sizes[b]``, 3 text tokens, pad to
    ``seq_len``.  Labels follow the reference convention: input ids with
    pad -> -100, everything else supervised (SURVEY.md §2.5 #4).
    """
    v = cfg.vision
    pins = cfg.image_grid_pinpoints
    ts = v.tokens_per_side
    if orig_sizes is None:
        orig_sizes = [(45 + 7 * b, 67 + 5 * b) for b in range(batch_size)]
    assert len(orig_sizes) == batch_size
    rng = np.random.default_rng(seed)
    tv = text_vocab or min(cfg.text.vocab_size, 1000)

    specs = [
        build_pack_spec(
            (h, w), pins, v.image_size, ts, cfg.vision_aspect_ratio_max,
            cfg.max_tiles, cfg.max_image_tokens,
        )
        for h, w in orig_sizes
    ]
    pack_idx, pack_w, pack_valid = stack_pack_specs(specs)

    ids = np.full((batch_size, seq_len), cfg.pad_token_id, dtype=np.int32)
    mask = np.zeros((batch_size, seq_len), dtype=np.int32)
    tile_valid = np.zeros((batch_size, cfg.max_tiles), dtype=bool)
    pixels = np.zeros(
        (batch_size, cfg.max_tiles, v.image_size, v.image_size, 3),
        dtype=np.float32,
    )
    for b, spec in enumerate(specs):
        n = spec.n_tokens
        seq = (
            list(rng.integers(0, tv, size=4))
            + [cfg.image_token_id] * n
            + list(rng.integers(0, tv, size=3))
        )
        if len(seq) > seq_len:
            raise ValueError(
                f"seq_len={seq_len} too small for {n} image tokens; "
                f"need >= {len(seq)}"
            )
        ids[b, : len(seq)] = seq
        mask[b, : len(seq)] = 1
        nt = num_tiles(orig_sizes[b], pins, v.image_size)
        nt = min(nt, spec.n_tiles)
        tile_valid[b, :nt] = True
        pixels[b, :nt] = rng.normal(size=(nt, v.image_size, v.image_size, 3)).astype(
            np.float32
        )

    labels = np.where(mask.astype(bool), ids, -100).astype(np.int32)

    batch = {
        "student_input_ids": ids,
        "student_attention_mask": mask,
        "student_pixel_values": pixels,
        "teacher_input_ids": ids.copy(),
        "teacher_attention_mask": mask.copy(),
        "teacher_pixel_values": pixels.copy(),
        "pack_idx": pack_idx,
        "pack_weight": pack_w,
        "pack_valid": pack_valid,
        "tile_valid": tile_valid,
        "labels": labels,
    }
    if accum is not None:
        batch = {
            k: np.broadcast_to(x, (accum,) + x.shape).copy()
            for k, x in batch.items()
        }
    return batch
