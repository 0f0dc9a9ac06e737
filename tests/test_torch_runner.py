"""The port's one-question answerer (``eval/runner.py``) against the JAX
package's, on the CPU, tiny config, float32, the same weights (the JAX
init carried across by ``models/convert.py::params_from_flax``):

* ``StudentAnswerer.answer`` gives the JAX ``StudentAnswerer``'s strings for
  seeded images of two sizes and several questions;
* ``load_student_for_eval`` restores the best (lowest val_loss) of two port
  checkpoints in a directory; refuses a directory that holds none, and a
  missing one (the JAX function keeps the random weights there); and raises
  without ``cpu`` when there is no CUDA device;
* ``cli/create_dataset.py --color_backend student --cpu`` writes the JAX
  CLI's CSVs, ``color.csv`` included, with the JAX side restoring an Orbax
  checkpoint of the same weights.  Both CLIs' runners are pinned to the tiny
  config (``tiny=True``): the CLIs build the 0.5B student.  The tiny random
  model's answers are hash-tokenizer ids (``<id>`` strings), none in the
  color vocabulary; ``color.csv`` is written before the merge's answer
  clean-up, so it holds them as generated."""

import argparse
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu import configs as jconfigs
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.cli import (
    common as jcommon,
    create_dataset as jax_create,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.eval import runner as jrunner
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.models import (
    LlavaOnevision as FlaxLlava,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.train.checkpoint import (
    CheckpointManager as JaxCheckpointManager,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch import configs
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli import (
    common,
    create_dataset,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.eval import runner
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.models.convert import (
    params_from_flax,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.train.checkpoint import (
    checkpoint_name,
)
from tests.test_torch_creation import csv_files, one_torch_thread, write_toolbox_tree  # noqa: F401

MAX_NEW = 6
QUESTIONS = ["What is the color of the chair?", "What is the color of the night stand?",
             "How many lamps are there?", "What is closest to the bed?"]


@pytest.fixture(scope="module")
def jax_student():
    """The JAX CLI's tiny init (seed 0) and the same weights as a port state dict."""
    cfg = jconfigs.llava_onevision_tiny()
    model = FlaxLlava(cfg, dtype=jnp.float32, attn_impl="xla")
    params = jcommon.init_or_load_params(model, cfg, None, 0)
    return model, cfg, params, params_from_flax(params, configs.llava_onevision_tiny())


def _port_model(state_dict):
    model = common.init_or_load_params(configs.llava_onevision_tiny(), None, 1, attn_impl="xla",
                                       device=torch.device("cpu"), dtype=torch.float32)
    model.load_state_dict(state_dict)
    return model


def _images():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 255, size + (3,)).astype(np.uint8) for size in ((40, 60), (40, 60), (45, 67))]


def test_answers_equal_the_jax_answerers(jax_student):
    jmodel, jcfg, params, sd = jax_student
    cfg = configs.llava_onevision_tiny()
    shim = argparse.Namespace(tokenizer_path=None)
    want_ans = jrunner.StudentAnswerer(jmodel, jcfg, jcommon.make_tokenizer(shim, jcfg), params,
                                       max_new_tokens=MAX_NEW, buckets=(256,))
    got_ans = runner.StudentAnswerer(_port_model(sd), cfg, common.make_tokenizer(shim, cfg),
                                     max_new_tokens=MAX_NEW, buckets=(256,))
    got, want = [], []
    for i, image in enumerate(_images()):
        for q in QUESTIONS[i % 2::2]:
            got.append(got_ans.answer(image, q))
            want.append(want_ans.answer(image, q))
    assert got == want
    assert all(got) and len(set(got)) > 1, got


def _save(ckdir, name, state_dict):
    os.makedirs(ckdir, exist_ok=True)
    torch.save({"params": state_dict, "opt_state": {}, "step": 0}, os.path.join(ckdir, name))


def test_load_student_for_eval_restores_the_best_checkpoint(jax_student, tmp_path, capsys):
    best_sd = jax_student[3]
    other = common.init_or_load_params(configs.llava_onevision_tiny(), None, 2, attn_impl="xla",
                                       device=torch.device("cpu"), dtype=torch.float32).state_dict()
    ckdir = str(tmp_path / "ck")
    _save(ckdir, checkpoint_name(0, 2.5), other)
    _save(ckdir, checkpoint_name(1, 1.25), best_sd)
    answer = runner.load_student_for_eval(ckdir, tiny=True, cpu=True, max_new_tokens=MAX_NEW)
    assert f"loaded student params from {os.path.join(ckdir, checkpoint_name(1, 1.25))}" in capsys.readouterr().out
    got = answer.__self__.model.state_dict()
    assert sorted(got) == sorted(best_sd)
    for k, v in best_sd.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)
    image, q = _images()[0], QUESTIONS[0]
    assert answer(image, q) == runner.StudentAnswerer(_port_model(best_sd), configs.llava_onevision_tiny(),
                                                      answer.__self__.tok, max_new_tokens=MAX_NEW,
                                                      buckets=(256,)).answer(image, q)


def test_load_student_for_eval_refuses_a_directory_without_checkpoints(tmp_path, monkeypatch):
    (tmp_path / "empty").mkdir()
    for d in (tmp_path / "empty", tmp_path / "missing"):
        with pytest.raises(SystemExit, match="no checkpoint"):
            runner.load_student_for_eval(str(d), tiny=True, cpu=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        runner.load_student_for_eval(None, tiny=True)


def test_student_color_backend_csvs_equal_the_jax_clis(jax_student, tmp_path, monkeypatch):
    _, _, params, sd = jax_student
    jck, pck = str(tmp_path / "jax_ck"), str(tmp_path / "port_ck")
    JaxCheckpointManager(jck).save(0, 1.0, {"params": params})
    _save(pck, checkpoint_name(0, 1.0), sd)
    monkeypatch.setattr(jrunner, "load_student_for_eval",
                        functools.partial(jrunner.load_student_for_eval, tiny=True, cpu=True))
    monkeypatch.setattr(runner, "load_student_for_eval", functools.partial(runner.load_student_for_eval, tiny=True))
    splits = (("validation", 4, 0),)
    flags = ["--splits", "validation", "--no_spellcheck", "--color_backend", "student"]
    jroot, proot = (write_toolbox_tree(tmp_path / name, splits) for name in ("jax", "port"))
    jax_create.main(["--root_data_dir", jroot, "--student_checkpoint", jck, *flags])
    create_dataset.main(["--root_data_dir", proot, "--student_checkpoint", pck, "--cpu", *flags])
    got, want = csv_files(proot), csv_files(jroot)
    assert sorted(got) == sorted(want) and "individual_datasets/validation/color.csv" in want
    for rel in want:
        assert got[rel] == want[rel], rel
    color = pd.read_csv(os.path.join(proot, "SUNRGBD", "csv_data", "individual_datasets", "validation",
                                     "color.csv"))
    assert len(color) == 4 and color["Answers"].str.len().gt(0).all()
