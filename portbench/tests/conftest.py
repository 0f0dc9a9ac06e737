"""Shared helpers of the benchmark's tests: run a cell of ``tests/data``
on the CPU, in this process, and parse its last line; plant a fault under
the timed path."""

import contextlib
import io
import json
from pathlib import Path

import pytest

DATA = Path(__file__).resolve().parent / "data"
# the faults a training cell can have; "teacher" only where there is a teacher
FAULTS = ("unchanged", "half", "altered", "teacher")


def run_cell(cell, seed=2**31 + 7, trace=0, data=DATA):
    """(exit code, the last line of stdout as JSON or None, stderr)."""
    import torch

    from portbench import run

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.05", "--trace", str(trace)],
                      data=data, device=torch.device("cpu"))
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


def plant(monkeypatch, fault: str) -> None:
    """Break the timed path of every system built after this: ``unchanged``,
    a step that leaves the state as it was; ``half``, half of each
    micro-batch left out and the mean taken over the rest; ``altered``, one
    leaf's gradient altered where the step produces it; ``teacher``, the
    teacher's logits rolled by one vocabulary column where they are
    produced."""
    from portbench import system

    build = system.System.__init__

    def init(self, *args, **kwargs):
        build(self, *args, **kwargs)
        opt = self.state.optimizer
        if fault == "unchanged":
            def apply(grads):
                opt.count += 1
            opt.apply = apply
        elif fault == "half":
            step = self.step
            self.step = lambda batch: step({k: v[:, : v.shape[1] // 2] for k, v in batch.items()})
        elif fault == "altered":
            apply, first = opt.apply, next(iter(opt.masters))
            opt.apply = lambda grads: apply({n: g * 2 if n == first else g for n, g in grads.items()})
        elif fault == "teacher":
            st = self.p["train.step"]
            inner = st._teacher_logits

            def rolled(*args, **kwargs):
                t, vis = inner(*args, **kwargs)
                return t.roll(1, dims=-1), vis
            monkeypatch.setattr(st, "_teacher_logits", rolled)
        else:
            raise ValueError(f"fault must be one of {FAULTS}")

    monkeypatch.setattr(system.System, "__init__", init)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
