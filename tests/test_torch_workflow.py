"""The researcher's workflow through the port's CLIs, on the CPU, tiny configs:

* ``test_create_train_evaluate_chain``: ``create_dataset`` (the student color
  backend, the default spell check) on a synthetic SUNRGBD toolbox tree ->
  ``dataset_statistics`` -> ``train_online_kd`` double_trouble phases 1, 2
  and 3 (one epoch each, each later phase starting from the previous one's
  best checkpoint) on the created CSVs -> ``evaluate_onevision`` with the
  phase-3 checkpoint on the created val split -> ``get_all_results``; each
  artifact is checked: the CSVs, finite losses, each phase's checkpoint,
  one prediction per val row, the summary row;
* ``test_training_improves_eval_accuracy``: the port's copy of
  ``tests/test_e2e_learning.py`` (untrained simple accuracy ~0, trained
  >= 0.66 on the 12-row synthetic val set), marked ``slow`` as the JAX one
  is: the phases run 61 epochs."""

import functools
import glob
import math
import os
import re

import pandas as pd
import pytest
import torch

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch import configs
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli import (
    common,
    create_dataset,
    dataset_statistics,
    evaluate_onevision,
    get_all_results,
    train_online_kd,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.eval import runner
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.eval.metrics import (
    simple_accuracy_metric,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.train.checkpoint import (
    CheckpointManager,
    find_best_checkpoint,
)
from tests.test_torch_creation import offline_spell_stage, one_torch_thread, write_toolbox_tree  # noqa: F401

PHASES = (1, 2, 3)


def test_create_train_evaluate_chain(tmp_path, monkeypatch, capsys, offline_spell_stage):  # noqa: F811
    # six val frames: the val merge gives each of the six question types one frame's rows
    root = write_toolbox_tree(tmp_path / "data", (("train", 3, 1), ("validation", 6, 0)))
    student = common.init_or_load_params(configs.llava_onevision_tiny(), None, 0, attn_impl="xla",
                                         device=torch.device("cpu"), dtype=torch.float32)
    color_ck = CheckpointManager(str(tmp_path / "color_student")).save(
        0, 1.0, {"params": student.state_dict(), "opt_state": {}, "step": 0})
    # the CLI builds the 0.5B student; the tiny one answers here
    monkeypatch.setattr(runner, "load_student_for_eval", functools.partial(runner.load_student_for_eval, tiny=True))

    create_dataset.main(["--root_data_dir", root, "--splits", "train", "validation", "--color_backend", "student",
                         "--student_checkpoint", os.path.dirname(color_ck), "--cpu"])
    out = capsys.readouterr().out
    assert re.findall(r"(train|validation): \d+ rows, (\d+) errors", out) == [("train", "0"), ("validation", "0")]
    csv_dir = os.path.join(root, "SUNRGBD", "csv_data")
    for split, n in (("train", 3), ("validation", 6)):
        color = pd.read_csv(os.path.join(csv_dir, "individual_datasets", split, "color.csv"))
        assert len(color) == n  # one Color row a frame: each has a prominent object
    val = pd.read_csv(os.path.join(csv_dir, "val_dataset.csv"))
    assert len(pd.read_csv(os.path.join(csv_dir, "train_dataset.csv"))) > 0 and len(val) > 0

    dataset_statistics.main(["--root_data_dir", root, "--accuracy", "0.45"])
    assert f"val: {len(val)} rows" in capsys.readouterr().out

    ck = tmp_path / "ck"
    best = None
    for phase in PHASES:
        train_online_kd.main(["--tiny_model", "--cpu", "--root_data_dir", root, "--phase", str(phase),
                              "--accumulate_grad_batches", "2", "--num_workers", "0", "--checkpoint_dir", str(ck),
                              "--tensorboard_dir", str(tmp_path / "tb")])
        out = capsys.readouterr().out
        losses = [float(v) for v in re.findall(r"step \d+ loss (\S+)", out) + re.findall(r"val_loss (\S+)", out)]
        assert losses and all(math.isfinite(v) for v in losses), out[-2000:]
        assert (f"phase hand-off: initialized from {best}" in out) == (phase > 1)
        best = find_best_checkpoint(str(ck / f"kd_double_trouble_phase{phase}"))
        assert best is not None, out[-2000:]

    preds = tmp_path / "preds"
    r = evaluate_onevision.main(["--tiny_model", "--cpu", "--root_data_dir", root, "--student_ckpt_path", best,
                                 "--predictions_dir", str(preds), "--max_new_tokens", "4", "--eval_batch_size", "4",
                                 "--metric_backend", "hashed"])
    pred = pd.read_csv(r["path"])
    assert list(pred["Question_Id"]) == list(val["Question_Id"]) and pred["Model_Answer"].notna().all()
    os.remove(preds / "summary" / "results_summary.csv")
    get_all_results.main(["--predictions_dir", str(preds), "--metric_backend", "hashed"])
    summary = pd.read_csv(preds / "summary" / "results_summary.csv")
    assert list(summary["File"]) == [os.path.basename(r["path"])]
    assert 0.0 <= summary["Simple_Accuracy"].iloc[0] <= 1.0


def _evaluate(root: str, pred_dir: str, ckpt) -> float:
    args = ["--synthetic_data", "--cpu", "--root_data_dir", root, "--prompt_style", "train", "--max_new_tokens", "4",
            "--eval_batch_size", "12", "--predictions_dir", pred_dir]
    if ckpt:
        args += ["--student_ckpt_path", ckpt]
    evaluate_onevision.main(args)
    csvs = glob.glob(os.path.join(pred_dir, "*.csv"))
    assert len(csvs) == 1, csvs
    df = pd.read_csv(csvs[0])
    assert len(df) == 12 and df["Model_Answer"].notna().any()
    return simple_accuracy_metric(df["Model_Answer"].fillna(""), df["Answers"].fillna(""))


@pytest.mark.slow
def test_training_improves_eval_accuracy(tmp_path):
    """``tests/test_e2e_learning.py`` through the port's CLIs, with its flags
    and phase-epoch calibration: ``--prompt_style train`` and
    ``--mask_prompt_labels`` let a from-scratch tiny model learn the 12
    answers; with a random-init teacher the KD terms work against the CE, so
    phase 3 runs few epochs at a small learning rate."""
    root = str(tmp_path / "data")
    ck = str(tmp_path / "ckpts")
    acc_before = _evaluate(root, str(tmp_path / "pred_before"), None)
    base = ["--synthetic_data", "--cpu", "--root_data_dir", root, "--batch_size", "12",
            "--accumulate_grad_batches", "1", "--mask_prompt_labels", "--kd_mode", "double_trouble",
            "--num_workers", "0", "--seed", "0", "--checkpoint_dir", ck, "--tensorboard_dir", str(tmp_path / "tb")]
    train_online_kd.main(base + ["--phase", "1", "--max_epochs", "1", "--learning_rate", "1e-3"])
    train_online_kd.main(base + ["--phase", "2", "--max_epochs", "56", "--learning_rate", "5e-3"])
    train_online_kd.main(base + ["--phase", "3", "--max_epochs", "4", "--learning_rate", "2e-4"])
    best = find_best_checkpoint(os.path.join(ck, "kd_double_trouble_phase3"))
    assert best, os.listdir(os.path.join(ck, "kd_double_trouble_phase3"))
    acc_after = _evaluate(root, str(tmp_path / "pred_after"), best)
    # untrained is ~0.0, trained overfit ~1.0; the margin allows for hash
    # collisions of the offline tokenizer
    assert acc_after >= acc_before + 0.5, (acc_before, acc_after)
    assert acc_after >= 0.66, acc_after
