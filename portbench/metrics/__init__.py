"""Per-layer metrics, one module each, found by the metric's name.

A module ``<name>.py`` declares ``UNIT``, ``LAYER`` (as PERF.md's list of
layers names it), ``MOVES`` (the end-to-end metric it should move) and
``read(ctx) -> float | None``; ``ctx`` is ``run.TraceContext``.  A reader
that finds nothing to read returns None, and the metric is left out."""
