"""On the card: a traced run of the baseline cell, whose every kernel of
the port falls into a named group, with ``correct`` true.  Skips without
a CUDA device; run on the card with
    python -m pytest -m cuda portbench/tests/test_portbench_cuda.py"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
def test_traced_run_on_the_card(cuda_device):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "base-b4x16", "--seed", "4242",
                          "--seconds", "1", "--trace", "1"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert "the port's kernels in no named group" not in out.stderr
    assert result["device"]["busy_s"] > 0
