"""The port's evaluator CLI (``cli/evaluate_onevision.py``) and results
aggregator (``cli/get_all_results.py``) on the CPU, tiny config, float32,
the 12-row synthetic SUNRGBD tree:

* the reference's predictions columns and file name, and the summary CSV;
* ``--eval_batch_size 2`` over 9 rows (a ragged tail padded to 2) gives the
  rows of the bs=1 run: same Question_Ids, answers and tokens, no pad row;
* ``--quant int8`` and ``int8_full`` run;
* ``--student_ckpt_path`` restores exactly: a model built from another seed
  with the checkpoint writes the CSV of the checkpoint's model, and without
  it writes another (the negative control); a missing file is refused;
* the predictions CSV equals the JAX CLI's on the same weights: the JAX CLI's
  own init (its seed), converted with ``params_from_flax`` and saved as a
  port checkpoint;
* ``get_all_results`` (``--file`` and the incremental mode) gives the JAX
  aggregator's summary on the same predictions."""

import os
import shutil

import jax
import pandas as pd
import pytest
import torch

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu import configs as jconfigs
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.cli import (
    common as jcommon,
    evaluate_onevision as jax_eval,
    get_all_results as jax_results,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.models import (
    LlavaOnevision as FlaxLlava,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch import configs
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli import (
    common,
    evaluate_onevision,
    get_all_results,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.models.convert import (
    params_from_flax,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.train.checkpoint import (
    CheckpointManager,
)

REF_COLUMNS = ["Question_Id", "Questions", "Question_Type", "Answers", "Model_Answer"]
CSV_NAME = "results_kd_modeltypeLdepth_val_double_troublephase3.csv"


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return str(common.ensure_synthetic_dataset(str(tmp_path_factory.mktemp("sunrgbd"))))


def _run(data_root, preds, *flags):
    return evaluate_onevision.main(["--synthetic_data", "--cpu", "--max_new_tokens", "4",
                                    "--root_data_dir", data_root, "--predictions_dir", str(preds), *flags])


def _csv(preds):
    return pd.read_csv(os.path.join(str(preds), CSV_NAME))


def _save_checkpoint(tmp_path, state_dict):
    return CheckpointManager(str(tmp_path / "ck")).save(0, 1.0, {"params": state_dict, "opt_state": {},
                                                                "step": 0})


def test_reference_columns_file_name_and_summary(data_root, tmp_path):
    out = _run(data_root, tmp_path / "p")
    assert sorted(os.listdir(tmp_path / "p")) == [CSV_NAME, "summary"]
    df = _csv(tmp_path / "p")
    assert list(df.columns) == REF_COLUMNS
    assert list(df["Question_Id"]) == list(range(12)) and len(out["rows"]) == 12
    assert all(len(r["tokens"]) == 4 and len(r["margins"]) == 4 for r in out["rows"])
    summary = pd.read_csv(tmp_path / "p" / "summary" / "results_summary.csv")
    assert {"Simple_Accuracy", "Neural_Similarity", "Backend", "File"} <= set(summary.columns)
    assert list(summary["File"]) == [CSV_NAME]


def test_batched_with_a_ragged_tail_equals_bs1(data_root, tmp_path):
    outs = {bs: _run(data_root, tmp_path / f"bs{bs}", "--subset_percentage", "0.75",
                     "--eval_batch_size", str(bs)) for bs in (1, 2)}
    a, b = _csv(tmp_path / "bs1"), _csv(tmp_path / "bs2")
    assert len(a) == 9 and list(a["Question_Id"]) == list(b["Question_Id"])
    assert list(a["Model_Answer"].fillna("")) == list(b["Model_Answer"].fillna(""))
    assert [r["tokens"] for r in outs[1]["rows"]] == [r["tokens"] for r in outs[2]["rows"]]


@pytest.mark.parametrize("quant", ["int8", "int8_full"])
def test_int8_runs(data_root, tmp_path, quant):
    _run(data_root, tmp_path / "p", "--quant", quant, "--subset_percentage", "0.25")
    df = _csv(tmp_path / "p")
    assert len(df) == 3 and df["Model_Answer"].notna().all()


def test_checkpoint_restore_is_exact(data_root, tmp_path):
    cfg = configs.llava_onevision_tiny()
    model = common.init_or_load_params(cfg, None, 0, attn_impl="xla", device=torch.device("cpu"),
                                       dtype=torch.float32)
    ckpt = _save_checkpoint(tmp_path, model.state_dict())
    flags = ("--subset_percentage", "0.5", "--eval_batch_size", "3")
    _run(data_root, tmp_path / "seed0", *flags)
    _run(data_root, tmp_path / "restored", "--seed", "1", "--student_ckpt_path", ckpt, *flags)
    _run(data_root, tmp_path / "seed1", "--seed", "1", *flags)
    want = _csv(tmp_path / "seed0")
    pd.testing.assert_frame_equal(_csv(tmp_path / "restored"), want)
    assert list(_csv(tmp_path / "seed1")["Model_Answer"]) != list(want["Model_Answer"])


def test_missing_checkpoint_is_refused(data_root, tmp_path):
    with pytest.raises(SystemExit, match="no such checkpoint file"):
        _run(data_root, tmp_path / "p", "--student_ckpt_path", str(tmp_path / "none.ckpt"))


@pytest.fixture(scope="module")
def jax_run(data_root, tmp_path_factory):
    """The JAX CLI on the synthetic tree (its own seeded init), and a port
    checkpoint of the same weights."""
    d = tmp_path_factory.mktemp("jax")
    flags = ["--synthetic_data", "--cpu", "--max_new_tokens", "4", "--root_data_dir", data_root,
             "--eval_batch_size", "4"]
    jax_eval.main([*flags, "--predictions_dir", str(d / "p")])
    cfg = jconfigs.llava_onevision_tiny()
    params = jcommon.init_or_load_params(FlaxLlava(cfg, dtype=jax.numpy.float32, attn_impl="xla"), cfg,
                                         None, 0)
    ckpt = _save_checkpoint(d, params_from_flax(params, configs.llava_onevision_tiny()))
    return d, flags, ckpt


def test_predictions_equal_the_jax_cli(jax_run, tmp_path):
    d, flags, ckpt = jax_run
    evaluate_onevision.main([*flags, "--predictions_dir", str(tmp_path / "p"), "--seed", "5",
                             "--student_ckpt_path", ckpt])
    pd.testing.assert_frame_equal(_csv(tmp_path / "p"), _csv(d / "p"))


@pytest.mark.parametrize("mode", ["file", "incremental"])
def test_get_all_results_equals_the_jax_aggregator(jax_run, tmp_path, capsys, mode):
    d, _, _ = jax_run
    outs = {}
    for name, cli in (("port", get_all_results), ("jax", jax_results)):
        preds = tmp_path / name
        shutil.copytree(d / "p", preds, ignore=shutil.ignore_patterns("summary"))
        shutil.copy(preds / CSV_NAME, preds / "second.csv")  # a second file for the incremental scan
        capsys.readouterr()
        if mode == "file":
            cli.main(["--file", str(preds / CSV_NAME), "--bert", "--metric_backend", "hashed"])
            outs[name] = capsys.readouterr().out
        else:
            cli.main(["--predictions_dir", str(preds), "--metric_backend", "hashed"])
            (preds / "third.csv").write_text((preds / CSV_NAME).read_text())
            cli.main(["--predictions_dir", str(preds), "--metric_backend", "hashed"])
            outs[name] = pd.read_csv(preds / "summary" / "results_summary.csv")
    if mode == "file":
        assert outs["port"] == outs["jax"] and "Simple_Accuracy" in outs["port"]
    else:
        pd.testing.assert_frame_equal(outs["port"], outs["jax"])
        assert list(outs["port"]["File"]) == [CSV_NAME, "second.csv", "third.csv"]
