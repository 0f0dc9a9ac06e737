"""A run of a cell, on the CPU at a test size: the last line's shape, the
reference against the port's plain routes, the faults and the control
that ``correct`` has to catch, and no result without a card."""

import json
from pathlib import Path

import pytest

from portbench import run

from .conftest import DATA, FAULTS, plant, run_cell

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = ("tiny-kd3", "tiny-kd1", "tiny-base")


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_ports_plain_routes(cell):
    """In float32 (the test configurations' dtype), the port's step on its
    plain CPU routes and the reference follow the same two steps."""
    rc, result, err = run_cell(cell)
    assert rc == 0, err[-3000:]
    checks = result["checks"]
    assert set(checks) == set(run.load("workloads", cell, DATA)["limits"])
    assert checks["loss_gap"]["value"] < 1e-5, checks
    assert checks["grad_gap"]["value"] < 1e-4, checks
    assert checks["change_gap"]["value"] < 1e-2, checks
    assert checks.get("loca_gap", {"value": 0.0})["value"] < 1e-4, checks
    assert checks.get("teacher_gap", {"value": 0.0})["value"] < 1e-5, checks
    assert result["correct"] is True


@pytest.mark.parametrize("trace", (0, 1))
def test_the_last_line(trace):
    rc, result, _ = run_cell("tiny-kd3", trace=trace)
    assert rc == 0
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert list(result["checks"]) == list(run.load("workloads", "tiny-kd3", DATA)["limits"])
    assert all(set(v) == {"value", "limit"} for v in result["checks"].values())
    assert result["attempted"] > 0 and result["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    units = {m["name"]: m["unit"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    for name, m in result["metrics"].items():
        assert m["unit"] == units[name] and isinstance(m["value"], float)
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "step_mfu_pct" in result["metrics"]
    else:
        assert set(result["metrics"]) == {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell, fault", [(c, f) for c in ("tiny-kd3", "tiny-base") for f in FAULTS
                                         if f != "teacher" or c != "tiny-base"] + [("tiny-kd1", "teacher")])
def test_a_broken_step_is_not_correct(cell, fault, monkeypatch):
    """Each fault a training cell can have, planted under the timed path."""
    plant(monkeypatch, fault)
    rc, result, err = run_cell(cell)
    assert rc == 0, err[-3000:]
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(cell):
    """The reference computed in float8 e4m3, put in the program's place,
    fails a limit that the float32 port passes with room."""
    import torch

    from portbench import control

    got = control.readings(cell, 2**31 + 11, torch.device("cpu"), data=DATA)
    limits = run.load("workloads", cell, DATA)["limits"]
    assert any(got["control"][c] > limits[c] for c in got["control"]), got
    assert any(got["half"][c] > limits[c] for c in got["half"]), got
    assert got["altered"]["grad_gap"] > limits["grad_gap"], got
    if "teacher_gap" in limits:
        assert got["control"]["teacher_gap"] > limits["teacher_gap"], got
        assert got["teacher"]["teacher_gap"] > limits["teacher_gap"], got


@pytest.mark.parametrize("cell", ("tiny-kd3", "tiny-kd1"))
def test_the_forward_readings(cell):
    """``control.py --forward``: the program's first step against the
    reference's forward, which reads as the full run's check of step 1
    does (the run's numbers are the worst over its check steps)."""
    import torch

    from portbench import control

    got = control.forward_readings(cell, 2**31 + 7, torch.device("cpu"), control=True, data=DATA)
    rc, result, _ = run_cell(cell)
    for c, v in got["program"].items():
        assert v <= result["checks"][c]["value"] * (1 + 1e-6) + 1e-12, (c, got, result)
    assert got["program"]["teacher_gap"] == pytest.approx(result["checks"]["teacher_gap"]["value"], rel=1e-6)
    assert set(got["program"]) == {"loss_gap", "teacher_gap"} | ({"loca_gap"} if cell == "tiny-kd3" else set())
    assert got["control"]["teacher_gap"] > 10 * got["program"]["teacher_gap"], got


def test_no_result_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    rc = run.main(["--workload", "kd3-b2x32", "--seed", "1", "--seconds", "1"])
    assert rc == 2 and capsys.readouterr().out == ""
