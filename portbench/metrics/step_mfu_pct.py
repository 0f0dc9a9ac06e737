"""The operations the window's steps need (``counts/step.py``: valid tiles,
the rows the loss reads, no recompute) over their wall time, against the
card's bf16 peak."""

from portbench.counts import peaks

UNIT, LAYER, MOVES = "%", "step (train/step.py)", "train_samples_per_s"


def read(ctx):
    w = ctx.window
    return None if w["seconds"] <= 0 else 100.0 * w["flops"] / w["seconds"] / peaks.BF16_FLOPS
