"""Device ms of the student's backward, the loss kernels' backward included
(the program's ``kdss.backward`` ranges, ``spans.py``) in the profiled
step, per sample."""

from portbench import spans

UNIT, LAYER, MOVES = "ms", "step (train/step.py)", "train_samples_per_s"


def read(ctx):
    ms = spans.span_ms(ctx.trace, "backward")
    return None if ms is None else ms / ctx.samples_per_step
