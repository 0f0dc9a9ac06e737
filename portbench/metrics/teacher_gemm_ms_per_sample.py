"""Device ms of the cuBLAS GEMMs inside the teacher's forward (the
``kernel_trace`` group within the program's ``kdss.teacher.forward``
ranges, ``spans.py``) in the profiled step, per sample.  The student's
GEMMs are ``gemm_ms_per_sample`` less this."""

from portbench import spans

UNIT, LAYER, MOVES = "ms", "model (models/)", "train_samples_per_s"


def read(ctx):
    ms = spans.span_ms(ctx.trace, "teacher.forward", group="GEMMs (cuBLAS)")
    return None if ms is None else ms / ctx.samples_per_step
