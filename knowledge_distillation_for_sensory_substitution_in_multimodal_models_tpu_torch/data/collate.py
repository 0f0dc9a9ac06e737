"""Static-shape dual-stream collation.

The port's copy of the JAX package's ``data/collate.py``.

Replaces the reference's ``collate_fn`` + double HF-processor call
(`CustomSUNRGBDOneVisionDataModule.py:95-167`) with a TPU-friendly batch:
every array is padded to a static (bucketed) shape so XLA compiles one
program per bucket instead of one per unique sequence length.

Emitted keys (train-step layout; the reference's
{rgb,depth}_{input_ids,pixel_values} map to teacher_*/student_*):

  student_input_ids / student_attention_mask / student_pixel_values   (depth)
  teacher_input_ids / teacher_attention_mask / teacher_pixel_values   (RGB)
  pack_idx / pack_weight / pack_valid / tile_valid    (shared: RGB and depth
      frames have identical sizes, reference quirk SURVEY.md §2.5 #9)
  labels        (input ids with pad -> -100; the reference supervises the
      full sequence incl. the prompt, SURVEY.md §2.5 #4)
  question_id   [B] int32
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..configs import LlavaOnevisionConfig
from .anyres import build_pack_spec, stack_pack_specs
from .chat import (
    render_eval_prompt,
    render_train_prompt,
    render_train_style_eval_prompt,
)
from .image_processing import process_anyres_batch
from .tokenization import Tokenizer, encode_with_image

IGNORE_INDEX = -100

# Default sequence buckets: 729-token base + up to 9x729 anyres grid +
# newlines + short QA text. Chosen as multiples of 128 covering SUNRGBD
# (530x730 -> 2936 tokens in the 3072 bucket) up to the anyres worst case.
DEFAULT_BUCKETS = (1024, 2048, 3072, 4096, 5120, 6144, 7552)


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"sequence length {n} exceeds largest bucket {buckets[-1]}")


class OneVisionCollator:
    def __init__(
        self,
        cfg: LlavaOnevisionConfig,
        tokenizer: Tokenizer,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        eval_mode: bool = False,
        mask_prompt_labels: bool = False,
        prompt_style: str = "reference",
    ):
        """``mask_prompt_labels=True`` supervises only the assistant-answer
        tokens (the correct-semantics variant; in the reference only the
        Pixtral collate does this via ``find_subsequence``,
        `CustomSUNRGBDPixtralDataModule.py:182-199,223-233` — the OneVision
        path supervises the full sequence, SURVEY.md §2.5 #4)."""
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.buckets = tuple(buckets)
        self.eval_mode = eval_mode
        self.mask_prompt_labels = mask_prompt_labels
        if prompt_style not in ("reference", "train"):
            raise ValueError(f"unknown prompt_style {prompt_style!r}")
        # "train": eval prompts use the training template's assistant
        # header verbatim (chat.render_train_style_eval_prompt) — for
        # from-scratch learning validation, not reference parity
        self.prompt_style = prompt_style

    def __call__(self, samples: List[tuple]) -> Dict[str, np.ndarray]:
        cfg, tok = self.cfg, self.tokenizer
        v = cfg.vision
        questions, answers, rgbs, depths, idxs = zip(*samples)

        specs = [
            build_pack_spec(
                rgb.shape[:2], cfg.image_grid_pinpoints, v.image_size,
                v.tokens_per_side, cfg.vision_aspect_ratio_max,
                cfg.max_tiles, cfg.max_image_tokens,
            )
            for rgb in rgbs
        ]
        pack_idx, pack_w, pack_valid = stack_pack_specs(specs)

        rgb_pixels, tile_valid = process_anyres_batch(list(rgbs), cfg)
        depth_pixels, _ = process_anyres_batch(list(depths), cfg)

        id_rows = []
        answer_spans = []  # [start, end) of answer tokens per row
        for q, a, spec in zip(questions, answers, specs):
            if self.eval_mode:
                text = None
                if self.prompt_style == "train":
                    text = render_train_style_eval_prompt(q)
                elif hasattr(tok, "render_eval"):
                    text = tok.render_eval(q)
                id_rows.append(encode_with_image(
                    tok, text or render_eval_prompt(q), spec.n_tokens
                ))
                answer_spans.append((0, 0))
                continue
            full = None
            if hasattr(tok, "render_train"):
                full = tok.render_train(q, a)
            full = full or render_train_prompt(q, a)
            row = encode_with_image(tok, full, spec.n_tokens)
            id_rows.append(row)
            if self.mask_prompt_labels:
                # answer span = the answer's token ids located by
                # re-encoding the prefix (user turn + assistant header) —
                # the semantics of the reference's Pixtral
                # `find_subsequence` masking
                # (`CustomSUNRGBDPixtralDataModule.py:182-199`) — plus the
                # turn-closing token right after the answer
                # (<|im_end|>/</s>): supervising the stop is what makes
                # greedy decode terminate after the answer.
                prefix_text = full[: full.rindex(str(a))]
                prefix = encode_with_image(tok, prefix_text, spec.n_tokens)
                n_answer = len(tok.encode(str(a)))
                end = len(prefix) + n_answer
                if end < len(row):
                    end += 1  # the closing special token
                answer_spans.append((len(prefix), end))
            else:
                answer_spans.append((0, len(row)))

        max_len = max(len(r) for r in id_rows)
        bucket = pick_bucket(max_len, self.buckets)
        b = len(samples)
        ids = np.full((b, bucket), tok.pad_token_id, dtype=np.int32)
        mask = np.zeros((b, bucket), dtype=np.int32)
        for i, row in enumerate(id_rows):
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1

        labels = np.where(mask.astype(bool), ids, IGNORE_INDEX).astype(np.int32)
        if self.mask_prompt_labels and not self.eval_mode:
            for i, (s0, s1) in enumerate(answer_spans):
                span_mask = np.zeros(bucket, dtype=bool)
                span_mask[s0:s1] = True
                labels[i] = np.where(span_mask, labels[i], IGNORE_INDEX)

        return {
            "student_input_ids": ids,
            "student_attention_mask": mask,
            "student_pixel_values": depth_pixels,
            "teacher_input_ids": ids.copy(),
            "teacher_attention_mask": mask.copy(),
            "teacher_pixel_values": rgb_pixels,
            "pack_idx": pack_idx,
            "pack_weight": pack_w,
            "pack_valid": pack_valid,
            "tile_valid": tile_valid,
            "labels": labels,
            "question_id": np.asarray(idxs, dtype=np.int32),
        }


def add_accum_axis(batches: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack A micro-batches into the train step's [A, B, ...] layout.

    All micro-batches must share one bucket; the loader groups them.
    """
    out = {}
    for k in batches[0]:
        out[k] = np.stack([b[k] for b in batches])
    return out
