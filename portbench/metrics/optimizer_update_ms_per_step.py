"""Device ms of the whole optimizer update: AdamW over the float32 masters
and the master -> bf16 copies (the program's ``kdss.optimizer`` range,
``spans.py``) in the profiled optimizer step."""

from portbench import spans

UNIT, LAYER, MOVES = "ms", "optimizer (train/optimizer.py)", "train_samples_per_s"


def read(ctx):
    return spans.span_ms(ctx.trace, "optimizer")
