"""Device ms of AdamW's foreach kernels (``multi_tensor_apply``) in the
profiled optimizer step."""

UNIT, LAYER, MOVES = "ms", "optimizer (train/optimizer.py)", "train_samples_per_s"


def read(ctx):
    ms = ctx.groups.get("AdamW (foreach)", 0.0)
    return ms if ms > 0 else None
