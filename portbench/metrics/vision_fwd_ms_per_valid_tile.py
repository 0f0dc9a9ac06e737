"""Device ms of SigLIP and the projector (the program's ``kdss.vision``
ranges, ``spans.py``; both towers in KD) in the profiled step, over the
valid anyres tiles of its samples: the padded tiles the towers also run
count as cost, not as work."""

from portbench import spans

UNIT, LAYER, MOVES = "ms", "model (models/)", "train_samples_per_s"


def read(ctx):
    ms = spans.span_ms(ctx.trace, "vision")
    tiles = sum(s.tiles for row in ctx.micro_batches for s in row)
    return None if ms is None or tiles <= 0 else ms / tiles
