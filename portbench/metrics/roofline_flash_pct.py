"""Roofline share of K1-K4 (ops/flash_attention.py) in the profiled step: the sum of each
launch's least time, from its shapes and masks at the work the inputs need
(``counts/roofline.py``), over the kernels' device time."""

from portbench import kernel_trace
from portbench.counts import roofline

UNIT, LAYER, MOVES = "%", "kernels (ops/, csrc/)", "train_samples_per_s"


def read(ctx):
    least = roofline.least_ms(ctx.config, ctx.job, ctx.seq_bucket, ctx.micro_batches, "flash", ctx.launches)
    flash = kernel_trace.flash_groups(ctx.trace.groups)
    return roofline.share_pct(least, sum(ctx.groups.get(g, 0.0) for g in flash))
