"""Share of the profiled step's kernel ms that lies in no phase of the
program's step: kernels that start in no ``kdss.*`` range (``spans.py``),
or in ``kdss.step`` alone, between or around its phases.  The device time
no phase metric sees.  None where no kernel lies in a phase."""

from portbench import spans

UNIT, LAYER, MOVES = "%", "step (train/step.py)", "train_samples_per_s"


def read(ctx):
    by = spans.self_ms(ctx.trace)
    unspanned = by.pop(None, 0.0) + by.pop(spans.STEP, 0.0)
    spanned = sum(by.values())
    return None if spanned <= 0 else 100.0 * unspanned / (spanned + unspanned)
