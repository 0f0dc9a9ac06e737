"""Legacy loader variants (reference `dataset/dataloader/`): the port's copy
of the JAX package's ``data/legacy.py``, over the port's
``data/dataset.py``; ``tests/test_torch_legacy.py`` holds it to the
original.

* :class:`FlorenceSUNRGBDDataset` — the Florence-2 era loader
  (`Florence/CustomSUNRGBDDataset.py:19-90`): same CSV/path scheme as the
  OneVision dataset but depth = RAW single channel stacked x3 (no
  normalization, `:63-66`) and a joint RGB+depth augmentation pipeline
  (`:35-43`).  Albumentations isn't available offline, so the pipeline is
  reimplemented in numpy with the same op set (hflip p=.5, brightness/
  contrast p=.2, shift p=.5, gaussian blur p=.2, coarse dropout p=.5,
  ImageNet normalize) and a seedable RNG — unlike the reference, the same
  transform is verifiably applied to both streams.
* :class:`BertVQADataset` — the BERT-tokenized ``CustomDataset``
  (`dataset/dataloader/CustomDataset.py`), which is import-broken in the
  reference (``Dataset`` never imported, `:21`); this is the working
  equivalent: tokenized question + answer ids with any tokenizer exposing
  ``__call__(text) -> ids``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .dataset import SUNRGBDVQADataset

_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _box_blur(img: np.ndarray, k: int = 3) -> np.ndarray:
    pad = k // 2
    padded = np.pad(img.astype(np.float32),
                    ((pad, pad), (pad, pad), (0, 0)), mode="edge")
    out = np.zeros_like(img, np.float32)
    for dy in range(k):
        for dx in range(k):
            out += padded[dy:dy + img.shape[0], dx:dx + img.shape[1]]
    return out / (k * k)


class FlorenceSUNRGBDDataset(SUNRGBDVQADataset):
    def __init__(
        self,
        root_data_dir: str,
        csv_file_name: str,
        subset_percentage: Optional[float] = None,
        augmentation: bool = True,
        seed: int = 0,
    ):
        super().__init__(root_data_dir, csv_file_name, subset_percentage,
                         depth_encoding="gray3")
        self.augmentation = augmentation
        self.rng = np.random.default_rng(seed)

    def _augment(self, rgb: np.ndarray, depth3: np.ndarray):
        r = self.rng
        if r.random() < 0.5:  # HorizontalFlip(p=0.5)
            rgb, depth3 = rgb[:, ::-1], depth3[:, ::-1]
        if r.random() < 0.2:  # RandomBrightnessContrast(p=0.2)
            alpha = 1.0 + r.uniform(-0.2, 0.2)
            beta = r.uniform(-0.2, 0.2) * 255.0
            rgb = np.clip(rgb.astype(np.float32) * alpha + beta, 0, 255)
        if r.random() < 0.5:  # ShiftScaleRotate -> integer shift variant
            h, w = rgb.shape[:2]
            sy = int(r.uniform(-0.1, 0.1) * h)
            sx = int(r.uniform(-0.1, 0.1) * w)
            rgb = np.roll(np.roll(rgb, sy, 0), sx, 1)
            depth3 = np.roll(np.roll(depth3, sy, 0), sx, 1)
        if r.random() < 0.2:  # GaussianBlur(p=0.2)
            rgb = _box_blur(np.asarray(rgb, np.float32))
        if r.random() < 0.5:  # CoarseDropout(p=0.5, <=8 16x16 holes)
            h, w = rgb.shape[:2]
            rgb = np.array(rgb, np.float32, copy=True)
            for _ in range(int(r.integers(1, 9))):
                y = int(r.integers(0, max(1, h - 16)))
                x = int(r.integers(0, max(1, w - 16)))
                rgb[y:y + 16, x:x + 16] = 0
        # A.Normalize(ImageNet) — applied to the RGB stream like the
        # reference's pipeline tail
        rgb = (np.asarray(rgb, np.float32) / 255.0 - _IMAGENET_MEAN) / _IMAGENET_STD
        return rgb, np.ascontiguousarray(depth3)

    def __getitem__(self, idx: int):
        question, answer, rgb, depth3, i = super().__getitem__(idx)
        if self.augmentation:
            rgb, depth3 = self._augment(rgb, depth3)
        return question, answer, rgb, depth3, i


class BertVQADataset(SUNRGBDVQADataset):
    """Working rebuild of the reference's broken BERT ``CustomDataset``:
    yields (question_ids [L], answer_ids [L], rgb, depth3, idx) with static
    padding to ``max_len``; tokenizer = anything exposing
    ``encode(text) -> List[int]`` (data/tokenization.py protocol)."""

    def __init__(
        self,
        root_data_dir: str,
        csv_file_name: str,
        tokenizer,
        max_len: int = 32,
        subset_percentage: Optional[float] = None,
    ):
        super().__init__(root_data_dir, csv_file_name, subset_percentage)
        self.tokenizer = tokenizer
        self.max_len = max_len

    def _encode(self, text: str) -> np.ndarray:
        ids = list(self.tokenizer.encode(str(text)))[: self.max_len]
        pad = getattr(self.tokenizer, "pad_token_id", 0)
        return np.asarray(
            ids + [pad] * (self.max_len - len(ids)), np.int32
        )

    def __getitem__(self, idx: int):
        question, answer, rgb, depth3, i = super().__getitem__(idx)
        return self._encode(question), self._encode(answer), rgb, depth3, i
