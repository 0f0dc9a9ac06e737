"""``--profile_dir`` in the port's trainers on the CPU: the baseline CLI and
the online-KD CLI (its default, double_trouble phase 1) accept it, as the JAX
CLIs do (``cli/common.py``), and trace train steps 2-4 with
``torch.profiler`` into that directory, the steps the JAX ``train/loop.py``
traces, with the step's ``kdss.*`` ranges (``utils/trace.py``); a run
shorter than the window still writes its trace."""

import json

import pytest

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli import (
    train,
    train_online_kd,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.train import (
    loop,
)


def _run(mod, tmp_path, *extra):
    mod.main([
        "--synthetic_data", "--cpu", "--accumulate_grad_batches", "1", "--num_workers", "1",
        "--root_data_dir", str(tmp_path / "data"), "--checkpoint_dir", str(tmp_path / "ck"),
        "--tensorboard_dir", str(tmp_path / "tb"), "--profile_dir", str(tmp_path / "prof"), *extra,
    ])


def _trace(tmp_path, name="trace_steps2-4.json"):
    path = tmp_path / "prof" / name
    assert path.is_file()
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)  # timed host operators
    return events


@pytest.mark.parametrize("mod", [train, train_online_kd], ids=["train", "train_online_kd"])
def test_profile_dir_writes_a_trace(tmp_path, capsys, mod):
    _run(mod, tmp_path)
    out = capsys.readouterr().out
    assert "training complete" in out and "profile: wrote" in out
    names = {e.get("name") for e in _trace(tmp_path)}
    assert {"kdss.step", "kdss.student.forward", "kdss.loss", "kdss.backward", "kdss.optimizer"} <= names
    assert ("kdss.teacher.forward" in names) == (mod is train_online_kd)


def test_a_run_shorter_than_the_window_still_writes_its_trace(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(loop, "PROFILE_STEPS", (2, 10**6))
    _run(train, tmp_path)
    assert "profile: wrote" in capsys.readouterr().out
    _trace(tmp_path, "trace_steps2-1000000.json")
