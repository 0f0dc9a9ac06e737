"""Threaded, prefetching host input pipeline.

The port's copy of the JAX package's ``data/loader.py``.

Replaces the reference's torch DataLoader workers
(`CustomSUNRGBDOneVisionDataModule.py` num_workers=4).  CPU-side work
(PIL decode, Prewitt, anyres tiling, tokenization) runs in a thread pool
(PIL/numpy release the GIL for the heavy parts); collated batches are
grouped by sequence bucket so the accumulation axis is shape-homogeneous,
then prefetched ahead of the device step.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List

import numpy as np

from .collate import OneVisionCollator, add_accum_axis


class OneVisionLoader:
    """Iterates [A, B, ...] accumulation batches.

    Note on bucketing x accumulation: micro-batches are grouped per bucket;
    a trailing group smaller than ``accum`` is dropped (train) or yielded
    padded by repetition (eval) — the reference's Lightning loop similarly
    leaves a ragged tail to ``accumulate_grad_batches``.
    """

    def __init__(
        self,
        dataset,
        collator: OneVisionCollator,
        batch_size: int = 1,
        accum: int = 1,
        shuffle: bool = False,
        seed: int = 0,
        num_workers: int = 4,
        prefetch: int = 2,
        drop_ragged: bool = True,
    ):
        self.dataset = dataset
        self.collator = collator
        self.batch_size = batch_size
        self.accum = accum
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.drop_ragged = drop_ragged
        self.epoch = 0

    def __len__(self) -> int:
        n_micro = len(self.dataset) // self.batch_size
        return n_micro // self.accum

    def _micro_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        bs = self.batch_size

        def load_collate(idx_group: List[int]):
            return self.collator([self.dataset[int(i)] for i in idx_group])

        groups = [
            order[i : i + bs] for i in range(0, len(order) - bs + 1, bs)
        ]
        if self.num_workers <= 1:
            for group in groups:
                yield load_collate(group)
            return
        with ThreadPoolExecutor(self.num_workers) as pool:
            inflight = collections.deque()
            it = iter(groups)
            for _ in range(self.num_workers + self.prefetch):
                g = next(it, None)
                if g is None:
                    break
                inflight.append(pool.submit(load_collate, g))
            while inflight:
                fut = inflight.popleft()
                g = next(it, None)
                if g is not None:
                    inflight.append(pool.submit(load_collate, g))
                yield fut.result()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """Yield [A, B, ...] batches, grouping micro-batches by bucket."""
        pending: Dict[int, List[Dict[str, np.ndarray]]] = collections.defaultdict(list)
        for micro in self._micro_batches():
            bucket = micro["student_input_ids"].shape[1]
            pending[bucket].append(micro)
            if len(pending[bucket]) == self.accum:
                yield add_accum_axis(pending.pop(bucket))
        if not self.drop_ragged:
            for bucket, group in pending.items():
                while len(group) < self.accum:
                    group.append(group[-1])
                yield add_accum_axis(group)
        self.epoch += 1
