"""The one traffic generator: a training job's micro-batches, from a
traffic file and ``--seed``.

A traffic file (``portbench/traffic/<name>.json``) gives the job (the
objective, its phase, the loss weights, the learning rate and AdamW's
settings), the micro-batch B and the accumulation A (one optimizer step is
A x B samples), the sequence bucket, the frames with their shares, the text
around the image block and the token-id range.  For optimizer step ``k``,
each of the A x B samples draws its frame by the shares (host RNG from
(seed, k)); its sequence is ``text_before_image`` random ids, the image
block sized by the frame's anyres geometry (``reference/anyres.py``), then
``text_after_image`` random ids, padded to ``seq_bucket``, with labels on
every real token.  Token ids and pixels (uniform in [-1, 1] on the frame's
valid tiles, 0 on the padded ones, one draw per stream) are drawn on the
device from (seed, k).  The same seed and step give the same tensors.
``check_rows`` draws, from the seed, the rows of a micro-batch at which
``correct`` compares the teacher's logits: real tokens only.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from .counts.step import Sample
from .reference import anyres
from .weights import stream_seed

IGNORE = -100
# rows of each sample at which the teacher's logits are compared
CHECK_ROWS_PER_SAMPLE = 4


@dataclasses.dataclass
class StepInputs:
    """One optimizer step's inputs: frames [A][B] as (height, width), the
    per-sample ``Sample`` (valid tiles, real tokens), and device tensors
    input_ids / attention_mask / labels [A, B, S] and pixels by stream
    [A, B, P, H, W, 3] float32."""

    frames: List[List[Tuple[int, int]]]
    samples: List[List[Sample]]
    input_ids: torch.Tensor
    attention_mask: torch.Tensor
    labels: torch.Tensor
    pixels: Dict[str, torch.Tensor]


class Traffic:
    def __init__(self, traffic: dict, config: dict, seed: int):
        self.t, self.seed = traffic, seed
        m = config["student"]
        vc = m["vision_config"]
        self.model = m
        self.tile = vc["image_size"]
        self.side = vc["image_size"] // vc["patch_size"]
        self.max_tiles = config["max_tiles"]
        self.frames = [(f["height"], f["width"]) for f in traffic["frames"]]
        shares = np.array([f["share"] for f in traffic["frames"]], dtype=np.float64)
        self.p = shares / shares.sum()
        self.geometry = {}
        for hw in self.frames:
            tiles = anyres.num_tiles(hw, m["image_grid_pinpoints"], self.tile)
            n_img = anyres.num_image_tokens(hw, m["image_grid_pinpoints"], self.tile, self.side,
                                            anyres.max_patches(m))
            tokens = traffic["text_before_image"] + n_img + traffic["text_after_image"]
            if tiles > self.max_tiles or tokens > traffic["seq_bucket"]:
                raise ValueError(f"frame {hw}: {tiles} tiles, {tokens} tokens exceed the budget")
            self.geometry[hw] = (tiles, n_img, tokens)

    @property
    def accumulate(self) -> int:
        return self.t["accumulate"]

    @property
    def micro_batch(self) -> int:
        return self.t["micro_batch"]

    @property
    def samples_per_step(self) -> int:
        return self.accumulate * self.micro_batch

    def frames_of(self, step: int) -> List[List[Tuple[int, int]]]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed % 2**64, 2, step]))
        pick = rng.choice(len(self.frames), size=(self.accumulate, self.micro_batch), p=self.p)
        return [[self.frames[i] for i in row] for row in pick]

    def check_rows(self, step: int, a: int) -> torch.Tensor:
        """Rows of micro-batch ``a`` of step ``step``, flattened over [B, S],
        at which the teacher's logits are compared: ``CHECK_ROWS_PER_SAMPLE``
        real tokens of each sample, drawn from (seed, step, a)."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed % 2**64, 5, step, a]))
        s = self.t["seq_bucket"]
        rows = [j * s + rng.choice(self.geometry[hw][2], size=CHECK_ROWS_PER_SAMPLE, replace=False)
                for j, hw in enumerate(self.frames_of(step)[a])]
        return torch.from_numpy(np.sort(np.concatenate(rows)))

    def make(self, step: int, device) -> StepInputs:
        t, m = self.t, self.model
        a, b, s = self.accumulate, self.micro_batch, t["seq_bucket"]
        frames = self.frames_of(step)
        kind = np.full((a, b, s), 2, dtype=np.int8)  # 0 text, 1 image, 2 pad
        tiles = np.zeros((a, b, self.max_tiles), dtype=np.float32)
        for i, row in enumerate(frames):
            for j, hw in enumerate(row):
                nt, n_img, tokens = self.geometry[hw]
                kind[i, j, :tokens] = 0
                kind[i, j, t["text_before_image"]:t["text_before_image"] + n_img] = 1
                tiles[i, j, :nt] = 1.0
        kind = torch.from_numpy(kind).to(device)
        g = torch.Generator(device=device)
        g.manual_seed(stream_seed(self.seed, 3, step))
        lo, hi = t["token_range"]
        ids = torch.randint(lo, hi, (a, b, s), generator=g, device=device)
        ids = torch.where(kind == 1, m["image_token_index"], torch.where(kind == 2, m["pad_token_id"], ids))
        mask = (kind != 2).to(torch.long)
        labels = torch.where(kind != 2, ids, IGNORE)
        valid = torch.from_numpy(tiles).to(device)[:, :, :, None, None, None]
        pixels = {}
        for k, stream in enumerate(t["streams"]):
            g.manual_seed(stream_seed(self.seed, 4, step, k))
            px = torch.rand((a, b, self.max_tiles, self.tile, self.tile, 3), generator=g, device=device)
            pixels[stream] = px.mul_(2).sub_(1).mul_(valid)
        samples = [[Sample(self.geometry[hw][0], self.geometry[hw][2]) for hw in row] for row in frames]
        return StepInputs(frames, samples, ids, mask, labels, pixels)
