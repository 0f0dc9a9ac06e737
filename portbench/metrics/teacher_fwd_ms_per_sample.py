"""Device ms of the frozen teacher's forward and its float32 logits at 1/T
(the program's ``kdss.teacher.forward`` ranges, ``spans.py``) in the
profiled step, per sample."""

from portbench import spans

UNIT, LAYER, MOVES = "ms", "step (train/step.py)", "train_samples_per_s"


def read(ctx):
    ms = spans.span_ms(ctx.trace, "teacher.forward")
    return None if ms is None else ms / ctx.samples_per_step
