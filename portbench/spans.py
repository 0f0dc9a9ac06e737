"""The program's own ranges in one profiled step: the ``kdss.*`` ranges the
port opens around the phases of its train step, read from the trace's host
events (``kernel_trace.StepTrace.host``), on the kernels' clock.

The port drains the card at each range's boundaries while a profiler
records, so every kernel a range launches starts inside its host interval.
Each kernel goes to the innermost range that holds its start; a kernel that
starts in none is unspanned.  A range's kernel ms include its children's,
as ``kernel_trace.ms_by_group`` sums kernels.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Tuple

from portbench import kernel_trace

PREFIX = "kdss."
STEP = PREFIX + "step"  # the whole step: it holds the phases, and no kernel is its own

_last: List[object] = [None, None]  # (trace, its sums): every reader reads the same step


def chains(trace: kernel_trace.StepTrace) -> List[Tuple[kernel_trace.Event, Tuple[str, ...]]]:
    """Each kernel with the names of the ranges that hold its start, the
    innermost first (empty for an unspanned kernel)."""
    ranges = sorted((e for e in trace.host if e.name.startswith(PREFIX)), key=lambda e: (e.start_us, -e.end_us))
    out, stack, i = [], [], 0
    for k in sorted(trace.kernels, key=lambda e: e.start_us):
        t = k.start_us
        while i < len(ranges) and ranges[i].start_us <= t:
            while stack and stack[-1].end_us < ranges[i].end_us:  # not its parent
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1].end_us < t:
            stack.pop()
        out.append((k, tuple(r.name for r in reversed(stack))))
    return out


def _sums(trace: kernel_trace.StepTrace) -> Dict[Tuple[Tuple[str, ...], str], float]:
    """Kernel ms by (chain, kernel group), read once a trace."""
    if _last[0] is not trace:
        out: Dict[Tuple[Tuple[str, ...], str], float] = collections.Counter()
        for k, names in chains(trace):
            out[names, kernel_trace.group_of(k.name, trace.groups)] += (k.end_us - k.start_us) / 1e3
        _last[:] = [trace, dict(out)]
    return _last[1]


def ms_by_span(trace: kernel_trace.StepTrace, group: Optional[str] = None) -> Dict[str, float]:
    """Kernel ms by range name, children included; ``group``: only the
    kernels of that ``kernel_trace`` group."""
    out: Dict[str, float] = collections.Counter()
    for (names, g), ms in _sums(trace).items():
        if group is None or g == group:
            for n in set(names):
                out[n] += ms
    return dict(out)


def self_ms(trace: kernel_trace.StepTrace) -> Dict[Optional[str], float]:
    """Kernel ms by the innermost range that holds each kernel (None: in no
    range); the values sum to all kernel ms of the step."""
    out: Dict[Optional[str], float] = collections.Counter()
    for (names, _), ms in _sums(trace).items():
        out[names[0] if names else None] += ms
    return dict(out)


def span_ms(trace: kernel_trace.StepTrace, name: str, group: Optional[str] = None) -> Optional[float]:
    """Kernel ms of the ``kdss.<name>`` ranges, children included; None
    where they hold no kernel (or the trace has none)."""
    ms = ms_by_span(trace, group).get(PREFIX + name, 0.0)
    return ms if ms > 0 else None
