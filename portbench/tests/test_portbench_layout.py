"""The benchmark finds its cells, configurations, traffic and metrics by
name, and a new one is a new file: nothing to edit."""

import json
import shutil
from pathlib import Path

from portbench import run

from .conftest import DATA, run_cell

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "portbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_cells_are_the_workload_files():
    for w in BENCH["workloads"]:
        cell = run.load("workloads", w["name"])
        assert {k: cell[k] for k in ("config", "traffic", "chips", "why")} == {
            k: w[k] for k in ("config", "traffic", "chips", "why")}
        run.load("traffic", w["traffic"])
        config, job = run.load("configs", w["config"]), run.load("traffic", w["traffic"])
        expect = {"loss_gap", "grad_gap", "change_gap"}
        expect |= {"teacher_gap"} if config.get("teacher") else set()
        expect |= {"loca_gap"} if job["objective"] == "double_trouble" and job["phase"] == 3 else set()
        assert list(cell["limits"]) == [c for c in run.CHECKS if c in expect]
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert (HERE / "reference" / f"{cfg['reference']}.py").is_file()


def test_every_per_layer_metric_has_a_reader_that_declares_it():
    mods = dict(run.metric_modules())
    assert {m["name"] for m in BENCH["per_layer"]} == set(mods)
    for m in BENCH["per_layer"]:
        mod = mods[m["name"]]
        assert (mod.UNIT, mod.LAYER, mod.MOVES) == (m["unit"], m["layer"], m["moves"])
        assert callable(mod.read)


def test_a_new_cell_is_a_new_file(tmp_path):
    data = tmp_path / "data"
    shutil.copytree(DATA, data)
    cell = json.loads((data / "workloads" / "tiny-base.json").read_text())
    cell["traffic"] = "tiny-longer"
    traffic = json.loads((data / "traffic" / "tiny-baseline.json").read_text())
    traffic["seq_bucket"] = 80
    (data / "traffic" / "tiny-longer.json").write_text(json.dumps(traffic))
    (data / "workloads" / "tiny-new.json").write_text(json.dumps(cell))
    rc, result, err = run_cell("tiny-new", data=data)
    assert rc == 0 and result["correct"], err[-2000:]


def test_a_new_metric_is_a_new_file(tmp_path):
    metrics = tmp_path / "metrics"
    shutil.copytree(HERE / "metrics", metrics)
    (metrics / "samples_per_step.py").write_text(
        'UNIT, LAYER, MOVES = "samples", "step (train/step.py)", "train_samples_per_s"\n\n\n'
        "def read(ctx):\n    return ctx.samples_per_step\n")
    names = [n for n, _ in run.metric_modules(metrics)]
    assert "samples_per_step" in names and len(names) == len(list(run.metric_modules())) + 1


def test_an_unknown_cell_is_refused():
    try:
        run.load("workloads", "no-such-cell")
    except SystemExit as e:
        assert "no-such-cell" in str(e)
    else:
        raise AssertionError("an unknown cell was accepted")
