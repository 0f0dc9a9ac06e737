"""Reading one profiled optimizer step: device kernels by group, the union
of kernel intervals, the idle gaps and what the host ran in them.

``GROUPS`` is a frozen copy of ``scripts/profile_torch_kd_step.py``'s
table (kernel-name substrings, the first match wins), kept here so that a
change to the program cannot regroup its own kernels; ``table`` adds the
groups of the cell's own language models, and a trace is read by the table
it carries.
"""

from __future__ import annotations

import bisect
import collections
import functools
from typing import Dict, List, NamedTuple, Tuple

from portbench import archs

GROUPS = (
    ("flash forward D=128 (teacher K3)", ("kdss_gqa90::fwd_kernel<128", "flash_fwd_kernel<128")),
    ("flash forward D=72 (K1)", ("kdss_fwd90", "flash_fwd_kernel<72")),
    ("flash forward D=64 (student K3)", ("kdss_gqa90::fwd_kernel<64", "flash_fwd_kernel")),
    ("flash backward D=72 (K2)", ("kdss_bwd72", "flash_bwd_dq_kernel<72", "flash_bwd_dkv_kernel<72")),
    ("flash backward D=64 (K4)", ("kdss_bwd90",)),
    ("fused CE forward (K5)", ("ce_fwd",)),
    ("temperature KL forward (K7)", ("kl_fwd",)),
    ("fused CE backward (K6)", ("kdss_ce90", "CERows")),
    ("temperature KL backward (K8)", ("kdss_kl90", "KLRows")),
    ("dh split reductions of a parent's mma.sync K6 and K8", ("reduce_dh",)),
    ("LoCa + CE (K11), LoCa (K9)", ("loca_", "LocaRows", "kdss_vocab90")),
    ("w8a8 GEMM K12 (int8 teacher)", ("kdss_int8",)),
    ("int8-head teacher logits K10", ("kdss_tmat",)),
    ("GEMMs (cuBLAS)", ("nvjet", "gemm", "xmma", "cutlass", "sm90_", "cublas")),
    ("AdamW (foreach)", ("multi_tensor_apply",)),
)
OTHER = "other (elementwise, casts, norms, reductions, copies)"
CUBLAS = "GEMMs (cuBLAS)"
PORT_KERNEL_MARK = "kdss"


def table(config: dict) -> tuple:
    """``GROUPS`` with the groups of ``config``'s language models
    (``archs/<model_type>.py``'s ``GROUPS``) after the port's and before
    cuBLAS's, which would otherwise take any kernel whose name holds
    "gemm".  Only the cell's own models are read, so a file that another
    configuration adds regroups nothing here."""
    own = []
    for stream in ("student", "teacher"):
        if config.get(stream):
            for g in archs.of(config[stream]["text_config"]).GROUPS:
                if g not in own:
                    own.append(g)
    i = [g for g, _ in GROUPS].index(CUBLAS)
    return GROUPS[:i] + tuple(own) + GROUPS[i:]


def flash_groups(groups: tuple) -> tuple:
    return tuple(g for g, _ in groups if g.startswith("flash"))


@functools.lru_cache(maxsize=None)
def group_of(name: str, groups: tuple = GROUPS) -> str:
    for group, keys in groups:
        if any(k in name for k in keys):
            return group
    return OTHER


class Event(NamedTuple):
    name: str
    start_us: float
    end_us: float


class StepTrace(NamedTuple):
    """One profiled step: its span on the host's clock (the ``portbench.step``
    annotation), the device kernels and the host's operators, in us, and
    the kernel groups it is read by."""

    span: Tuple[float, float]
    kernels: List[Event]
    host: List[Event]
    groups: tuple = GROUPS


STEP_ANNOTATION = "portbench.step"


def from_profiler(prof, groups: tuple = GROUPS) -> StepTrace:
    """The trace of a ``torch.profiler.profile`` around one annotated step,
    read from the profiler's raw events, to be read by ``groups``."""
    import torch

    raw = prof.profiler.kineto_results.events()
    kernels, host, span = [], [], None
    for e in raw:
        start = e.start_ns() / 1e3
        end = start + e.duration_ns() / 1e3
        annotation = e.is_user_annotation() if hasattr(e, "is_user_annotation") else False
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not annotation and e.name() != STEP_ANNOTATION:
                kernels.append(Event(e.name(), start, end))
        elif e.name() == STEP_ANNOTATION:
            span = (start, end)
        else:
            host.append(Event(e.name(), start, end))
    if span is None:
        raise ValueError(f"no {STEP_ANNOTATION!r} range in the trace")
    kernels = [k for k in kernels if k.end_us > span[0] and k.start_us < span[1]]
    return StepTrace(span, kernels, host, groups)


def ms_by_group(trace: StepTrace) -> Dict[str, float]:
    out: Dict[str, float] = collections.Counter()
    for k in trace.kernels:
        out[group_of(k.name, trace.groups)] += (k.end_us - k.start_us) / 1e3
    return dict(out)


def busy_intervals(trace: StepTrace) -> List[Tuple[float, float]]:
    """The union of the kernel intervals, clipped to the step's span."""
    lo, hi = trace.span
    merged: List[List[float]] = []
    for k in sorted(trace.kernels, key=lambda e: e.start_us):
        a, b = max(k.start_us, lo), min(k.end_us, hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy_us(trace: StepTrace) -> float:
    return sum(b - a for a, b in busy_intervals(trace))


def span_us(trace: StepTrace) -> float:
    return trace.span[1] - trace.span[0]


def idle_gaps(trace: StepTrace) -> List[Tuple[float, float]]:
    lo, hi = trace.span
    gaps, t = [], lo
    for a, b in busy_intervals(trace):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return gaps


HOST_LOOKBACK = 64


def idle_by_host_op(trace: StepTrace, top: int = 10) -> List[Tuple[str, float]]:
    """Idle seconds summed by the host operator at each gap's midpoint, the
    longest first: the latest-started of the ``HOST_LOOKBACK`` operators
    that started last before it and still run (the innermost one; a gap that
    only an older, outer operator covers counts as no operator)."""
    host = sorted(trace.host, key=lambda e: e.start_us)
    starts = [e.start_us for e in host]
    out: Dict[str, float] = collections.Counter()
    for a, b in idle_gaps(trace):
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid)
        name = "(no host operator)"
        for e in reversed(host[max(0, i - HOST_LOOKBACK):i]):
            if e.end_us > mid:
                name = e.name
                break
        out[name[:100]] += (b - a) / 1e6
    return sorted(out.items(), key=lambda kv: -kv[1])[:top]


def top_kernels(trace: StepTrace, top: int = 10) -> List[Tuple[str, float]]:
    out: Dict[str, float] = collections.Counter()
    for k in trace.kernels:
        out[k.name[:100]] += (k.end_us - k.start_us) / 1e6
    return sorted(out.items(), key=lambda kv: -kv[1])[:top]


def stray_port_kernels(trace: StepTrace) -> List[str]:
    """Names of the port's own kernels that fall into the "other" group."""
    return sorted({k.name[:120] for k in trace.kernels
                   if PORT_KERNEL_MARK in k.name and group_of(k.name, trace.groups) == OTHER})


def top_other(trace: StepTrace, top: int = 8) -> List[Tuple[str, float]]:
    out: Dict[str, float] = collections.Counter()
    for k in trace.kernels:
        if group_of(k.name, trace.groups) == OTHER:
            out[k.name[:100]] += (k.end_us - k.start_us) / 1e3
    return sorted(out.items(), key=lambda kv: -kv[1])[:top]
