"""A kernel family's roofline share over one profiled step: the sum of
its launches' least times (``kernels.bound`` of each launch's operations
and bytes, ``step.micro_batch_launches``) over the device time of its
kernel groups in the trace.  A family whose launches the program did not
count as expected gives no share: the path changed, and its work must be
counted anew."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from . import kernels, step

# the port's counters of each family, and the launches each makes in one
# micro-batch, by the kernels of ``step.micro_batch_launches``
COUNTERS = {
    "flash": {"flash_fwd_d72": ("K1", "K1 teacher"), "flash_bwd_d72": ("K2",), "flash_fwd_d64": ("K3 d64",),
              "flash_fwd_d128": ("K3 d128",), "flash_bwd_d64": ("K4",)},
    "loca_ce": {"loca_ce_fwd": ("K11 fwd",), "loca_ce_bwd": ("K11 bwd",)},
    "kl": {"kl_fwd": ("K7",), "kl_bwd": ("K8 dh",), "kl_bwd_dw": ()},
    "ce": {"ce_fwd": ("K5",), "ce_bwd": ("K6",)},
}


def least_ms(config: dict, job: dict, seq_bucket: int, micro_batches: Sequence[Sequence[step.Sample]],
             family: str, launches: Dict[str, int]) -> Optional[float]:
    """The family's least time over the step's micro-batches, or None when
    the counted launches differ from the step's structure."""
    total, expected = 0.0, {}
    for samples in micro_batches:
        rows = step.micro_batch_launches(config, job, seq_bucket, samples).get(family)
        if rows is None:
            return None
        for name, flops, nbytes, count in rows:
            total += kernels.bound(flops, nbytes)[0] * count
            expected[name] = expected.get(name, 0) + count
    for counter, names in COUNTERS[family].items():
        if launches.get(counter, 0) != sum(expected.get(n, 0) for n in names):
            return None
    return total


def share_pct(least: Optional[float], device_ms: float) -> Optional[float]:
    if least is None or device_ms <= 0:
        return None
    return 100.0 * least / device_ms
