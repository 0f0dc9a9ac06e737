"""Device ms of every kernel outside the named groups (elementwise work,
casts, norms, reductions, copies) in the profiled step, per sample."""

from portbench import kernel_trace

UNIT, LAYER, MOVES = "ms", "model and losses (models/, losses/)", "train_samples_per_s"


def read(ctx):
    ms = ctx.groups.get(kernel_trace.OTHER, 0.0)
    return ms / ctx.samples_per_step if ms > 0 else None
