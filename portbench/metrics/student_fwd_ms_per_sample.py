"""Device ms of the student's forward (SigLIP, projector, pack, language model; the
program's ``kdss.student.forward`` ranges, ``spans.py``) in the profiled
step, per sample."""

from portbench import spans

UNIT, LAYER, MOVES = "ms", "step (train/step.py)", "train_samples_per_s"


def read(ctx):
    ms = spans.span_ms(ctx.trace, "student.forward")
    return None if ms is None else ms / ctx.samples_per_step
