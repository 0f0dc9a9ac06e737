"""Worker-process input pipeline with the JAX package's Grain loader contract
(port of ``data/grain_pipeline.py``), built on ``torch.utils.data.DataLoader``.

:func:`make_grain_loader` reads a map-style (len/getitem) source, e.g.
``data/dataset.py::SUNRGBDVQADataset``, in ``read_threads`` worker
processes (spawned, so the source and the collator must pickle), collates
each micro-batch of ``batch_size`` samples in the worker, and groups the
micro-batches by their sequence bucket into [A, B, ...] accumulation
batches, as the Grain loader and ``data/loader.py::OneVisionLoader`` do.
The card's machine has no ``grain`` and the port imports none.

The order is Grain's where it is defined by the contract: epochs
concatenated, then cut into micro-batches (one may span two epochs), the
last partial micro-batch dropped.  With ``shuffle`` each epoch is a
permutation drawn from one ``torch.Generator`` seeded with ``seed``: the
same seed gives the same order, which is the port's own and not Grain's.
"""

from __future__ import annotations

from typing import Iterator, Optional

import torch
from torch.utils.data import DataLoader, Dataset

from .collate import add_accum_axis


class _MicroBatches(Dataset):
    """Item i: the collated micro-batch of the source's samples ``groups[i]``."""

    def __init__(self, source, collator, groups):
        self.source, self.collator, self.groups = source, collator, groups

    def __len__(self) -> int:
        return len(self.groups)

    def __getitem__(self, i: int) -> dict:
        return self.collator([self.source[j] for j in self.groups[i]])


def _as_is(micro: dict) -> dict:
    """The DataLoader's collate_fn: the collator has batched already."""
    return micro


def micro_batch_groups(n: int, batch_size: int, shuffle: bool, seed: int, num_epochs: int) -> list:
    """The source indices of each micro-batch (see the module docstring)."""
    gen = torch.Generator().manual_seed(seed)
    order = []
    for _ in range(num_epochs):
        order += (torch.randperm(n, generator=gen) if shuffle else torch.arange(n)).tolist()
    return [order[i:i + batch_size] for i in range(0, len(order) - batch_size + 1, batch_size)]


def make_grain_loader(
    dataset,
    collator,
    batch_size: int = 1,
    accum: int = 1,
    shuffle: bool = False,
    seed: int = 0,
    num_epochs: Optional[int] = 1,
    read_threads: int = 4,
):
    """Returns an iterator of [A, B, ...] accumulation batches.

    Bucketing: each micro-batch is collated with the normal per-batch bucket
    pick (longest sample -> smallest covering bucket), then micro-batches
    are grouped by their bucket before stacking the accumulation axis;
    leftover partial groups are flushed at the end, largest bucket first,
    repeat-padded to A.  ``num_epochs`` None reads one epoch, as the Grain
    loader does; ``read_threads`` 0 reads in this process.
    """
    epochs = num_epochs if num_epochs is not None and num_epochs > 1 else 1
    groups = micro_batch_groups(len(dataset), batch_size, shuffle, seed, epochs)
    workers = max(0, read_threads)
    loader = DataLoader(
        _MicroBatches(dataset, collator, groups), batch_size=None, shuffle=False, num_workers=workers,
        collate_fn=_as_is, multiprocessing_context="spawn" if workers else None,
        prefetch_factor=-(-2 * accum // workers) if workers else None,
    )

    def batches() -> Iterator[dict]:
        pending: dict = {}
        for micro in loader:
            bucket = micro["student_input_ids"].shape[1]
            pending.setdefault(bucket, []).append(micro)
            if len(pending[bucket]) == accum:
                yield add_accum_axis(pending.pop(bucket))
        for bucket in sorted(pending, reverse=True):
            group = pending[bucket]
            while len(group) < accum:
                group.append(group[-1])
            yield add_accum_axis(group)

    return batches()
