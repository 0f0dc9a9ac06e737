"""Device ms of the gradient accumulation: the float32 carry, its adds, the
metric sums and the mean over the micro-batches (the program's
``kdss.accumulate`` ranges, ``spans.py``) in the profiled optimizer step."""

from portbench import spans

UNIT, LAYER, MOVES = "ms", "step (train/step.py)", "train_samples_per_s"


def read(ctx):
    return spans.span_ms(ctx.trace, "accumulate")
