"""Roofline share of K5 and K6 (ops/fused_ce.py) in the profiled step: the sum of each
launch's least time, from its shapes and masks at the work the inputs need
(``counts/roofline.py``), over the kernels' device time."""

from portbench.counts import roofline

UNIT, LAYER, MOVES = "%", "kernels (ops/, csrc/)", "train_samples_per_s"
GROUPS = ("fused CE forward (K5)", "fused CE backward (K6)")


def read(ctx):
    least = roofline.least_ms(ctx.config, ctx.job, ctx.seq_bucket, ctx.micro_batches, "ce", ctx.launches)
    return roofline.share_pct(least, sum(ctx.groups.get(g, 0.0) for g in GROUPS))
