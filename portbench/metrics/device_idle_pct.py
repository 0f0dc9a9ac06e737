"""Share of an optimizer step in which no operation ran on the device:
1 - (union of the kernel intervals of the profiled step) / (the mean step
time of the unprofiled window).  The profiler stretches the host's side of
the profiled step, not its kernels, so the busy time is read from the trace
and the step's length from the window."""

from portbench import kernel_trace

UNIT, LAYER, MOVES = "%", "device", "train_samples_per_s"


def read(ctx):
    w = ctx.window
    if w["steps"] <= 0 or w["seconds"] <= 0:
        return None
    return 100.0 * (1.0 - kernel_trace.busy_us(ctx.trace) / 1e6 / (w["seconds"] / w["steps"]))
