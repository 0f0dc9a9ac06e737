"""Flag parity of the port's CLIs with the JAX package's, from each pair's
``build_parser()``:

* for all 11 CLI pairs, every option of the JAX parser is an option of the
  port's, with the same default and at least the JAX choices (the port adds
  ``--cpu`` to ``create_dataset`` and ``flash`` to ``--attn_impl``);
* a JAX serving command line with each of the ten flags the port's serving
  CLIs used to refuse (the trainers' eight host flags, ``--mesh`` and
  ``--distributed``) parses with the port's ``inference`` and
  ``evaluate_onevision`` parsers to the JAX values; the eight host flags'
  help says that these CLIs do not read them;
* ``cli/inference.py`` accepts a one-rank ``--mesh`` and refuses
  ``--distributed`` and a ``--mesh`` over more than one rank, naming the
  evaluator."""

import importlib

import pytest

JAX = "knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.cli."
PORT = "knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli."
CLIS = ["convert_weights", "create_dataset", "dataset_statistics", "evaluate_onevision", "evaluate_pixtral",
        "get_all_results", "inference", "openai_eval_depth", "panesar_baseline", "train", "train_online_kd"]
HOST_FLAGS = {"--checkpoint_dir": "ck", "--tensorboard_dir": "tb", "--profile_dir": "prof", "--num_workers": "2",
              "--depth_encoding": "gray3", "--train_csv": "t.csv", "--val_csv": "v.csv", "--dataset": "daquar"}


def _parsers(name):
    return (importlib.import_module(JAX + name).build_parser(), importlib.import_module(PORT + name).build_parser())


def test_every_jax_cli_has_its_port():
    import os

    jax_dir = os.path.dirname(importlib.import_module(JAX + "common").__file__)
    assert sorted(f[:-3] for f in os.listdir(jax_dir) if f.endswith(".py") and f not in ("__init__.py", "common.py")) \
        == CLIS


@pytest.mark.parametrize("name", CLIS)
def test_every_jax_option_parses_with_the_port(name):
    jp, pp = _parsers(name)
    positional = [a.dest for a in pp._actions if not a.option_strings]
    assert positional == [a.dest for a in jp._actions if not a.option_strings]
    for a in jp._actions:
        for opt in a.option_strings:
            b = pp._option_string_actions.get(opt)
            assert b is not None, f"{name}: {opt}"
            assert (b.dest, b.option_strings, b.default, b.nargs, type(b).__name__) == \
                (a.dest, a.option_strings, a.default, a.nargs, type(a).__name__), (name, opt)
            assert set(a.choices or ()) <= set(b.choices or ()), (name, opt)


@pytest.mark.parametrize("name", ["inference", "evaluate_onevision"])
def test_a_jax_serving_command_line_with_the_ten_flags_parses(name):
    argv = ["--synthetic_data", "--cpu", "--distributed", "--mesh", "1,1,1"]
    for k, v in HOST_FLAGS.items():
        argv += [k, v]
    jp, pp = _parsers(name)
    want, got = vars(jp.parse_args(argv)), vars(pp.parse_args(argv))
    for dest in [k[2:] for k in HOST_FLAGS] + ["mesh", "distributed"]:
        assert got[dest] == want[dest], dest
    helps = {a.dest: a.help for a in pp._actions}
    assert all("does not read" in helps[k[2:]] for k in HOST_FLAGS)


def test_inference_refuses_a_multi_rank_launch(tmp_path, capsys):
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli import inference

    base = ["--synthetic_data", "--cpu", "--max_new_tokens", "2", "--root_data_dir", str(tmp_path)]
    for flags in (["--distributed"], ["--mesh", "1,2,1"], ["--distributed", "--mesh", "1,1,1"]):
        with pytest.raises(SystemExit, match="evaluate_onevision.py generates under --distributed --mesh"):
            inference.main(base + flags)
    inference.main(base + ["--mesh", "1,1,1", "--num_workers", "3"])
    assert "Model_Answer" in capsys.readouterr().out
