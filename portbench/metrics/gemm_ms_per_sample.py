"""Device ms of the cuBLAS GEMMs in the profiled step, per sample."""

UNIT, LAYER, MOVES = "ms", "model (models/)", "train_samples_per_s"


def read(ctx):
    ms = ctx.groups.get("GEMMs (cuBLAS)", 0.0)
    return ms / ctx.samples_per_step if ms > 0 else None
