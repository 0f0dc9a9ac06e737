"""The readers of the program's ``kdss.*`` ranges (``spans.py`` and the
metrics that read it): on hand-built traces, in a traced run on the CPU,
and (marked ``cuda``) in a traced run of a baseline cell cut to two layers
a tower on the card."""

import contextlib
import io
import json
import shutil
import types
from pathlib import Path

import pytest

from portbench import kernel_trace, run, spans
from portbench.counts.step import Sample

from .conftest import run_cell

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
READERS = {m["name"] for m in BENCH["per_layer"]
           if m["name"] in {"student_fwd_ms_per_sample", "teacher_fwd_ms_per_sample", "teacher_gemm_ms_per_sample",
                            "loss_fwd_ms_per_sample", "backward_ms_per_sample", "accumulate_ms_per_step",
                            "optimizer_update_ms_per_step", "vision_fwd_ms_per_valid_tile", "unspanned_busy_pct"}}
TEACHER = {"teacher_fwd_ms_per_sample", "teacher_gemm_ms_per_sample"}
E = kernel_trace.Event


def _trace(host, kernels):
    return kernel_trace.StepTrace((0.0, 1000.0), kernels, host)


# a step: student forward [10, 100] holding vision [20, 50]; teacher forward
# [100, 200] holding vision [110, 150]; backward [200, 400]; optimizer
# [400, 450]; all inside kdss.step [5, 460]; an aten op the host ran
HOST = [E("kdss.step", 5, 460), E("kdss.student.forward", 10, 100), E("kdss.vision", 20, 50),
        E("kdss.teacher.forward", 100, 200), E("kdss.vision", 110, 150), E("kdss.backward", 200, 400),
        E("kdss.optimizer", 400, 450), E("aten::mm", 21, 22)]
KERNELS = [E("before", 1, 3),  # before every range: unspanned
           E("siglip_s", 25, 45), E("nvjet_student", 60, 90),  # vision, then the student's LM
           E("siglip_t", 120, 140), E("nvjet_teacher", 160, 199),
           E("kdss_bwd90", 210, 390), E("multi_tensor_apply", 410, 430),
           E("late", 470, 480)]  # after kdss.step: unspanned


def test_a_kernel_goes_to_the_innermost_range():
    got = {k.name: names for k, names in spans.chains(_trace(HOST, KERNELS))}
    assert got["siglip_s"] == ("kdss.vision", "kdss.student.forward", "kdss.step")
    assert got["nvjet_teacher"] == ("kdss.teacher.forward", "kdss.step")
    assert got["multi_tensor_apply"] == ("kdss.optimizer", "kdss.step")
    assert got["before"] == () and got["late"] == ()


def test_a_range_sums_its_childrens_kernels():
    trace = _trace(HOST, KERNELS)
    by = spans.ms_by_span(trace)
    assert by["kdss.student.forward"] == pytest.approx((20 + 30) / 1e3)
    assert by["kdss.vision"] == pytest.approx((20 + 20) / 1e3)
    assert by["kdss.step"] == pytest.approx((20 + 30 + 20 + 39 + 180 + 20) / 1e3)
    assert spans.span_ms(trace, "teacher.forward", group="GEMMs (cuBLAS)") == pytest.approx(39 / 1e3)
    own = spans.self_ms(trace)
    assert own[None] == pytest.approx(12 / 1e3) and own["kdss.vision"] == pytest.approx(40 / 1e3)
    assert sum(own.values()) == pytest.approx(sum(kernel_trace.ms_by_group(trace).values()))


def _read(trace, samples=4):
    ctx = types.SimpleNamespace(trace=trace, samples_per_step=samples,
                                micro_batches=[[Sample(tiles=5, tokens=100)] * 2] * 2)
    mods = dict(run.metric_modules())
    return {n: mods[n].read(ctx) for n in READERS}


def test_the_readers():
    got = _read(_trace(HOST, KERNELS))
    assert got["student_fwd_ms_per_sample"] == pytest.approx(50 / 1e3 / 4)
    assert got["teacher_gemm_ms_per_sample"] == pytest.approx(39 / 1e3 / 4)
    assert got["vision_fwd_ms_per_valid_tile"] == pytest.approx(40 / 1e3 / 20)
    assert got["optimizer_update_ms_per_step"] == pytest.approx(20 / 1e3)
    assert got["unspanned_busy_pct"] == pytest.approx(100 * 12 / (12 + 309))
    assert got["loss_fwd_ms_per_sample"] is None and got["accumulate_ms_per_step"] is None


def test_a_kernel_between_phases_counts_as_unspanned():
    """A kernel inside ``kdss.step`` but in none of its phases is unspanned."""
    kernels = KERNELS + [E("between", 452, 456)]
    assert dict(spans.chains(_trace(HOST, kernels)))[kernels[-1]] == ("kdss.step",)
    got = _read(_trace(HOST, kernels))
    assert got["unspanned_busy_pct"] == pytest.approx(100 * (12 + 4) / (12 + 4 + 309))
    assert got["unspanned_busy_pct"] > _read(_trace(HOST, KERNELS))["unspanned_busy_pct"]


def test_no_reading_without_the_programs_ranges():
    """A program without spans (the parent of the change that added them),
    and a trace with ranges but no kernel in them (the CPU)."""
    host = [e for e in HOST if not e.name.startswith(spans.PREFIX)]
    assert set(_read(_trace(host, KERNELS)).values()) == {None}
    assert set(_read(_trace(HOST, [])).values()) == {None}


def test_a_traced_run_on_the_cpu_carries_the_ranges(monkeypatch):
    traces, read = [], kernel_trace.from_profiler

    def keep(prof, *args):
        traces.append(read(prof, *args))
        return traces[-1]

    monkeypatch.setattr(kernel_trace, "from_profiler", keep)
    rc, result, err = run_cell("tiny-kd3", trace=1)
    assert rc == 0, err[-3000:]
    names = {e.name for e in traces[0].host if e.name.startswith(spans.PREFIX)}
    assert names == {"kdss.step", "kdss.tile_layout", "kdss.student.forward", "kdss.vision", "kdss.teacher.forward",
                     "kdss.loss", "kdss.backward", "kdss.accumulate", "kdss.optimizer"}
    assert not READERS & set(result["metrics"])  # no kernels on the CPU


@pytest.mark.cuda
def test_a_traced_baseline_cell_on_the_card(cuda_device, tmp_path):
    """base-b4x16 cut to two layers a tower and two micro-batches."""
    data = tmp_path / "data"
    for kind in ("configs", "traffic", "workloads"):
        shutil.copytree(ROOT / "portbench" / kind, data / kind)
    config = json.loads((data / "configs" / "llava-ov-0.5b-depth.json").read_text())
    for tower in ("vision_config", "text_config"):
        config["student"][tower]["num_hidden_layers"] = 2
    (data / "configs" / "llava-ov-0.5b-depth.json").write_text(json.dumps(config))
    job = json.loads((data / "traffic" / "baseline-b4x16.json").read_text())
    job["accumulate"] = 2
    (data / "traffic" / "baseline-b4x16.json").write_text(json.dumps(job))
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", "base-b4x16", "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "1"],
                      data=data, device=cuda_device)
    assert rc == 0, err.getvalue()[-4000:]
    metrics = json.loads(out.getvalue().strip().splitlines()[-1])["metrics"]
    assert READERS - TEACHER <= set(metrics) and not TEACHER & set(metrics), sorted(metrics)
    assert metrics["unspanned_busy_pct"]["value"] < 1, metrics
