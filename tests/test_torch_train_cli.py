"""The port's baseline training CLI on the CPU: it trains the tiny config on
the synthetic SUNRGBD tree, prints a finite val_loss, writes a checkpoint
named by it, resumes from it; it trains on the synthetic DAQUAR tree; and
the training modules' freedom from jax."""

import math
import os
import re
import subprocess
import sys

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli import (
    train,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.train import (
    checkpoint,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch"


def _run(tmp_path, *extra):
    return train.main([
        "--synthetic_data", "--cpu", "--accumulate_grad_batches", "1", "--num_workers", "1",
        "--root_data_dir", str(tmp_path / "data"), "--checkpoint_dir", str(tmp_path / "ck"),
        "--tensorboard_dir", str(tmp_path / "tb"), *extra,
    ])


def test_train_cli_trains_saves_and_resumes(tmp_path, capsys):
    _run(tmp_path)
    out = capsys.readouterr().out
    val = [float(v) for v in re.findall(r"val_loss (\S+)", out)]
    assert len(val) == 1 and math.isfinite(val[0])
    assert "training complete" in out
    ckpt_dir = tmp_path / "ck" / "baseline_depth"
    best = checkpoint.find_best_checkpoint(str(ckpt_dir))
    assert best is not None and os.path.basename(best) == checkpoint.checkpoint_name(0, val[0])
    saved = checkpoint.CheckpointManager(str(ckpt_dir)).restore(best)
    assert saved["step"] == 12  # 12 synthetic rows, B=1, A=1
    assert set(saved) == {"params", "opt_state", "step"}

    _run(tmp_path, "--load_checkpoint")
    out = capsys.readouterr().out
    assert f"resumed from {best} at step 12" in out
    assert "epoch 0 step 20 loss" in out  # the step count carries on
    val2 = float(re.findall(r"val_loss (\S+)", out)[0])
    assert math.isfinite(val2) and val2 < val[0]
    assert os.listdir(ckpt_dir) == [checkpoint.checkpoint_name(0, val2)]  # top-1 pruning


def test_train_cli_trains_daquar(tmp_path, capsys):
    """``--dataset daquar --synthetic_data``: 8 synthetic DAQUAR rows (CSVs
    at the root, images/ and depth/) through the port's DAQUAR reader."""
    _run(tmp_path, "--dataset", "daquar")
    out = capsys.readouterr().out
    val = [float(v) for v in re.findall(r"val_loss (\S+)", out)]
    assert len(val) == 1 and math.isfinite(val[0])
    assert "training complete" in out
    saved = checkpoint.CheckpointManager(str(tmp_path / "ck" / "baseline_depth")).restore_best()[0]
    assert saved["step"] == 8  # 8 synthetic rows, B=1, A=1


def test_checkpoint_names_and_policy(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    assert checkpoint.extract_val_loss("epoch=03-val_loss=0.1234.ckpt") == 0.1234
    assert checkpoint.extract_val_loss("preempt-step=7.ckpt") == float("inf")
    first = mgr.save(0, 2.5, {"step": 1})
    assert mgr.save(1, 3.0, {"step": 2}) is None  # no improvement, nothing saved
    second = mgr.save(2, 1.25, {"step": 3})
    assert not os.path.exists(first) and os.path.exists(second)
    snap = mgr.save_preempt(9, {"step": 9})
    assert os.path.basename(snap) == "preempt-step=9.ckpt"
    restored, path = mgr.restore_best()
    assert path == second and restored == {"step": 3}


def test_training_modules_import_no_jax():
    """A fresh process (this one has jax loaded by tests/conftest.py)."""
    code = (
        "import sys\n"
        f"import {PKG}.cli.train, {PKG}.train, {PKG}.train.loop, {PKG}.train.checkpoint\n"
        f"import {PKG}.ops.fused_ce, {PKG}.losses, {PKG}.models.convert\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "ok"
