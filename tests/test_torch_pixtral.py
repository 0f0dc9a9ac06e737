"""The port's Pixtral evaluator (``cli/evaluate_pixtral.py``) against the JAX
package's, on the CPU (tiny config, float32, the 12-row synthetic tree):

* ``extract_answer`` gives the JAX function's strings on a table of model
  outputs;
* with one stub answer function in both CLIs' runner (``load_student_for_
  eval``), the two predictions directories are equal file by file (the
  results CSV, the summary);
* with the real student backend on the same weights (the JAX CLI's init,
  an Orbax checkpoint for the JAX CLI and its ``params_from_flax``
  conversion for the port's), equal file by file;
* a row whose image is missing counts as an error in both CLIs, with equal
  CSVs; an exception of the answer backend fails the port's CLI (the JAX
  loop counts it as an error, leaves the row out and exits 0);
* ``--backend hf`` without ``--model_path`` exits, and a multi-rank launch
  is refused."""

import os

import jax.numpy as jnp
import pytest
import torch

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu import configs as jconfigs
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.cli import (
    common as jcommon,
    evaluate_pixtral as jax_pixtral,
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
    evaluate_pixtral,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.eval import runner
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.models.convert import (
    params_from_flax,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.train.checkpoint import (
    checkpoint_name,
)

OUTPUTS = ["The color is. Red", "I see 3 chairs. 3", "There are 3", "chair", "", "a.b.c. 12 ", "Yes.",
           "There are 21 lamps and 2 beds", "<s>[INST]what?[/INST] Two.", "It is 1.5 m away"]


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def test_extract_answer_equals_jax():
    assert [evaluate_pixtral.extract_answer(t) for t in OUTPUTS] == [jax_pixtral.extract_answer(t) for t in OUTPUTS]
    assert evaluate_pixtral.extract_answer("I see 3 chairs. 3") == "three"
    assert evaluate_pixtral.ADDITIONAL_INSTRUCTIONS == jax_pixtral.ADDITIONAL_INSTRUCTIONS


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return common.ensure_synthetic_dataset(str(tmp_path_factory.mktemp("sunrgbd")))


def _files(d):
    out = {}
    for base, _, names in os.walk(d):
        for n in names:
            path = os.path.join(base, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, d)] = f.read()
    return out


def _run_both(tree, tmp_path, jflags=(), pflags=(), data=("--synthetic_data",)):
    common_flags = [*data, "--cpu", "--max_new_tokens", "4", "--root_data_dir", tree]
    jax_pixtral.main([*common_flags, "--predictions_dir", str(tmp_path / "jax"), *jflags])
    out = evaluate_pixtral.main([*common_flags, "--predictions_dir", str(tmp_path / "port"), *pflags])
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(got) == sorted(want) == ["results_val_pixtral.csv", os.path.join("summary", "results_summary.csv")]
    for rel in want:
        assert got[rel] == want[rel], rel
    return out


def _stub(image, question):
    return f"I see {image.shape[0]} things. {question.split()[-1]} {image.shape[1] % 3}"


def test_stub_backend_csvs_equal_jax(tree, tmp_path, monkeypatch):
    monkeypatch.setattr(jrunner, "load_student_for_eval", lambda *a, **k: _stub)
    monkeypatch.setattr(runner, "load_student_for_eval", lambda *a, **k: _stub)
    out = _run_both(tree, tmp_path)
    assert len(out["rows"]) == 12 and out["errors"] == 0


def test_student_backend_csvs_equal_jax(tree, tmp_path, monkeypatch):
    cfg = jconfigs.llava_onevision_tiny()
    params = jcommon.init_or_load_params(FlaxLlava(cfg, dtype=jnp.float32, attn_impl="xla"), cfg, None, 0)
    jck, pck = str(tmp_path / "jax_ck"), str(tmp_path / "port_ck")
    JaxCheckpointManager(jck).save(0, 1.0, {"params": params})
    os.makedirs(pck)
    torch.save({"params": params_from_flax(params, configs.llava_onevision_tiny()), "opt_state": {}, "step": 0},
               os.path.join(pck, checkpoint_name(0, 1.0)))
    calls = []
    real = runner.load_student_for_eval

    def spy(*a, **k):
        calls.append((a, k))
        return real(*a, **k)

    monkeypatch.setattr(runner, "load_student_for_eval", spy)
    out = _run_both(tree, tmp_path, ["--student_ckpt_dir", jck], ["--student_ckpt_dir", pck])
    assert calls == [((pck, None), dict(tiny=True, cpu=True, max_new_tokens=4))]
    assert len(out["rows"]) == 12 and len({r["Model_Answer"] for r in out["rows"]}) > 1


def test_a_missing_image_is_an_error_and_a_backend_failure_fails(tree, tmp_path, monkeypatch):
    import shutil

    root = str(tmp_path / "data")
    shutil.copytree(tree, root)
    os.remove(os.path.join(root, "SUNRGBD", "img", "rgb_4.png"))
    monkeypatch.setattr(jrunner, "load_student_for_eval", lambda *a, **k: _stub)
    monkeypatch.setattr(runner, "load_student_for_eval", lambda *a, **k: _stub)
    out = _run_both(root, tmp_path, data=("--tiny_model",))
    assert out["errors"] == 1 and [r["Question_Id"] for r in out["rows"]] == [i for i in range(12) if i != 4]

    def broken(*a, **k):
        def answer(image, question):
            if "number 7" in question:
                raise RuntimeError("the answer backend failed")
            return _stub(image, question)
        return answer

    monkeypatch.setattr(runner, "load_student_for_eval", broken)
    with pytest.raises(RuntimeError, match="the answer backend failed"):
        evaluate_pixtral.main(["--tiny_model", "--cpu", "--root_data_dir", root, "--predictions_dir",
                               str(tmp_path / "p2")])
    assert not (tmp_path / "p2").exists()
    # the JAX loop counts the same failure as an error and exits 0, the row missing (a fault of the reference)
    monkeypatch.setattr(jrunner, "load_student_for_eval", broken)
    jax_pixtral.main(["--tiny_model", "--cpu", "--root_data_dir", root, "--predictions_dir", str(tmp_path / "p3")])
    assert len((tmp_path / "p3" / "results_val_pixtral.csv").read_text().strip().splitlines()) == 1 + 10


def test_hf_backend_without_a_model_path_exits_and_a_mesh_is_refused(tree, tmp_path):
    argv = ["--synthetic_data", "--cpu", "--root_data_dir", tree, "--predictions_dir", str(tmp_path / "p")]
    with pytest.raises(SystemExit, match="--backend hf needs --model_path"):
        evaluate_pixtral.main([*argv, "--backend", "hf"])
    for flags in (["--distributed"], ["--mesh", "1,2,1"]):
        with pytest.raises(SystemExit, match="one process"):
            evaluate_pixtral.main([*argv, *flags])
    assert not (tmp_path / "p").exists()
