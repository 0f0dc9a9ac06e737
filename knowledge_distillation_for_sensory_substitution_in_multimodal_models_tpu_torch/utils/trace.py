"""Named ranges inside the train step, on the profiler's clock.

``span(name)`` marks a phase of the step (``train/step.py`` lists them) as
the ``torch.profiler`` range ``kdss.<name>``.  It records only while a
profiler records (``with torch.profiler.profile()`` or ``profile.start()``);
otherwise it is one boolean check.  The ranges live in the profiler's
memory and go out with its trace: ``train/loop.py``'s ``--profile_dir``
file and the benchmark's traced step.

While it records, a span synchronises the card when it opens and again
before it closes.  The host runs ahead of the card, and autograd launches
the backward's kernels from its own thread, so a kernel's start time says
nothing of the range that launched it unless the card is drained at each
boundary: then every kernel a span launches starts and ends inside the
span's host interval, and a reader gives each kernel to the innermost range
that holds its start.  The drains cost only the profiled steps.
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "kdss."


@contextlib.contextmanager
def span(name: str):
    if not torch.autograd.profiler._is_profiler_enabled:
        yield
        return
    drain = torch.cuda.is_initialized()
    if drain:
        torch.cuda.synchronize()
    with torch.profiler.record_function(PREFIX + name):
        yield
        if drain:
            torch.cuda.synchronize()
