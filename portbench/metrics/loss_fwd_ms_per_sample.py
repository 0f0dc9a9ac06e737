"""Device ms of the loss's forward: the labels, the vocabulary terms (K5,
K7, K11), NT-Xent and their combination (the program's ``kdss.loss``
ranges, ``spans.py``) in the profiled step, per sample."""

from portbench import spans

UNIT, LAYER, MOVES = "ms", "step (train/step.py)", "train_samples_per_s"


def read(ctx):
    ms = spans.span_ms(ctx.trace, "loss")
    return None if ms is None else ms / ctx.samples_per_step
