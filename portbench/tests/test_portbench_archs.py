"""The language model is chosen by its ``model_type``: one file of the
harness (``archs/``) and one of the reference (``reference/lm/``) an
architecture, and a new one is two new files.

``data/pinned.json`` holds what the harness read for both benchmark
configurations before the Qwen2 code moved into ``archs/qwen2.py`` and
``reference/lm/qwen2.py``: each model's leaves (their count and the SHA-256
of their JSON), the operations of a sample and the kernel launches of a
micro-batch at each of the four SUNRGBD frames (and of one micro-batch
holding all four) in the KD phase 3, KD phase 1 and baseline jobs, the
kernel groups and the group of a few kernel names.  The move may change
none of it, and an architecture that another configuration adds changes
no grouping of these."""

import hashlib
import json
import shutil
from pathlib import Path

import pytest

from portbench import archs, kernel_trace, run, system, weights
from portbench.counts import step
from portbench.reference import lm
from portbench.traffic import Traffic

from .conftest import DATA, run_cell

HERE = Path(__file__).resolve().parents[1]
PINNED = json.loads((DATA / "pinned.json").read_text())
JOBS = {"base": ("llava-ov-0.5b-depth", "baseline-b4x16", {}),
        "kd3": ("llava-ov-0.5b-depth-kd-7b", "phase3-b2x32", {}),
        "kd1": ("llava-ov-0.5b-depth-kd-7b", "phase3-b2x32", {"phase": 1})}


def _job(name):
    config_name, traffic, override = JOBS[name]
    return run.load("configs", config_name), {**run.load("traffic", traffic), **override}


def _rows(launches):
    return {family: [list(r) for r in rows] for family, rows in launches.items()}


def _reading(section, key):
    if section == "leaves":
        config_name, stream = key.split("/")
        text = json.dumps([list(leaf) for leaf in weights.leaves(run.load("configs", config_name)[stream])])
        return {"count": len(json.loads(text)), "sha256": hashlib.sha256(text.encode()).hexdigest()}
    if section == "groups":
        return [[g, list(keys)] for g, keys in kernel_trace.table(_job(key)[0])]
    if section == "group_of":
        groups = kernel_trace.table(_job(key)[0])
        return {n: kernel_trace.group_of(n, groups) for n in PINNED["group_of"]}
    name, frame = key.split("/")
    config, job = _job(name)
    sb = job["seq_bucket"]
    if frame == "mixed":
        samples = [step.Sample(*s) for s in PINNED["launches"][key]["samples"]]
        return {"samples": [list(s) for s in samples], **_rows(step.micro_batch_launches(config, job, sb, samples))}
    tiles, _, tokens = Traffic(job, config, 0).geometry[tuple(int(x) for x in frame.split("x"))]
    s = step.Sample(tiles, tokens)
    if section == "flops":
        return {"sample": list(s), "flops": step.sample_flops(config, job, sb, s)}
    return _rows(step.micro_batch_launches(config, job, sb, [s] * job["micro_batch"]))


@pytest.mark.parametrize("section, key", [(s, k) for s in ("leaves", "flops", "launches") for k in PINNED[s]]
                         + [(s, k) for s in ("groups", "group_of") for k in ("base", "kd3")])
def test_the_move_changes_no_reading(section, key):
    want = PINNED[section] if section in ("groups", "group_of") else PINNED[section][key]
    assert _reading(section, key) == want


def test_the_kernel_groups_are_the_frozen_table():
    assert [[g, list(keys)] for g, keys in kernel_trace.GROUPS] == PINNED["groups"]
    assert kernel_trace.flash_groups(kernel_trace.GROUPS) == tuple(
        g for g, _ in kernel_trace.GROUPS if g.startswith("flash"))


def test_another_architectures_groups_stay_in_its_own_cells(tmp_path, monkeypatch):
    """An architecture file whose groups would take the cuBLAS kernels and
    add a flash group regroups nothing in the cells that do not run it,
    and goes after the port's groups and before cuBLAS's in one that does."""
    (tmp_path / "archs").mkdir()
    shutil.copy(archs.DIR / "qwen2.py", tmp_path / "archs" / "qwen2.py")
    source = (archs.DIR / "qwen2.py").read_text().replace(
        "GROUPS: tuple = ()", 'GROUPS: tuple = (("flash MLA forward", ("kdss_mla",)), ("experts", ("gemm",)))')
    (tmp_path / "archs" / "greedy.py").write_text(source)
    monkeypatch.setattr(archs, "DIR", tmp_path / "archs")
    tiny = run.load("configs", "tiny-kd", DATA)
    for config in [tiny] + [_job(k)[0] for k in ("base", "kd3")]:
        assert kernel_trace.table(config) == kernel_trace.GROUPS
    tiny["teacher"]["text_config"]["model_type"] = "greedy"
    groups = kernel_trace.table(tiny)
    names = [g for g, _ in groups]
    assert names.index("experts") == names.index(kernel_trace.CUBLAS) - 1
    assert [g for g in names if g not in ("flash MLA forward", "experts")] == [g for g, _ in kernel_trace.GROUPS]
    assert kernel_trace.group_of("void cutlass::gemm_kernel", groups) == "experts"
    assert kernel_trace.group_of("void cutlass::gemm_kernel") == kernel_trace.CUBLAS
    assert "flash MLA forward" in kernel_trace.flash_groups(groups)


def _tree():
    """Every file under portbench/ but Python's bytecode caches, with its
    size and modification time."""
    return {str(p.relative_to(HERE)): (p.stat().st_size, p.stat().st_mtime_ns)
            for p in HERE.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_language_model_is_new_files(tmp_path, monkeypatch):
    """An architecture added as two files outside portbench/, named in the
    configurations, runs the tiny baseline and KD cells as Qwen2 does."""
    before = _tree()
    qwen2 = {cell: run_cell(cell) for cell in ("tiny-base", "tiny-kd3")}
    name = "qwen2_twin"
    for kind, source in (("archs", archs.DIR), ("lm", lm.DIR)):
        (tmp_path / kind).mkdir()
        shutil.copy(source / "qwen2.py", tmp_path / kind / f"{name}.py")
    monkeypatch.setattr(archs, "DIR", tmp_path / "archs")
    monkeypatch.setattr(lm, "DIR", tmp_path / "lm")
    data = tmp_path / "data"
    shutil.copytree(DATA, data)
    for path in (data / "configs").glob("*.json"):
        config = json.loads(path.read_text())
        for stream in ("student", "teacher"):
            if config.get(stream):
                config[stream]["text_config"]["model_type"] = name
        path.write_text(json.dumps(config))
    for cell, (rc, result, _) in qwen2.items():
        assert rc == 0 and result["correct"] is True
        rc_new, got, err = run_cell(cell, data=data)
        assert rc_new == 0 and got["correct"] is True, err[-2000:]
        assert got["checks"] == result["checks"]
    assert _tree() == before


@pytest.mark.parametrize("model_type, missing", [(None, "must name its language model"),
                                                 ("../qwen2", "must name its language model"),
                                                 ("qwen9", "archs/qwen9.py")])
def test_a_text_config_must_name_its_language_model(tmp_path, monkeypatch, model_type, missing):
    data = tmp_path / "data"
    shutil.copytree(DATA, data)
    path = data / "configs" / "tiny.json"
    config = json.loads(path.read_text())
    config["student"]["text_config"].pop("model_type")
    if model_type is not None:
        config["student"]["text_config"]["model_type"] = model_type
    path.write_text(json.dumps(config))
    monkeypatch.setattr(system.System, "__init__", lambda *a, **k: pytest.fail("set-up began"))
    with pytest.raises(SystemExit, match=missing.replace(".", r"\.")):
        run_cell("tiny-base", data=data)


def test_the_reference_needs_its_file_too(tmp_path, monkeypatch):
    (tmp_path / "archs").mkdir()
    shutil.copy(archs.DIR / "qwen2.py", tmp_path / "archs" / "qwen2_twin.py")
    monkeypatch.setattr(archs, "DIR", tmp_path / "archs")
    config = run.load("configs", "tiny", DATA)
    config["student"]["text_config"]["model_type"] = "qwen2_twin"
    with pytest.raises(SystemExit, match=r"reference/lm/qwen2_twin\.py"):
        run.check_language_models(config)


@pytest.mark.parametrize("remat", ("full", None))
def test_a_remat_the_harness_ignores_is_refused(remat):
    import torch

    config = run.load("configs", "tiny", DATA)
    if remat is None:
        del config["remat"]
    else:
        config["remat"] = remat
    with pytest.raises(ValueError, match="remat"):
        system.System(config, run.load("traffic", "tiny-baseline", DATA), 1, torch.device("cpu"))
