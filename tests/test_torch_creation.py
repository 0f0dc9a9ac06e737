"""The port's dataset-creation layer against the JAX package's, on the CPU:

* every copied module (``data/creation/*.py``, ``utils/spelling.py``,
  ``eval/statistics.py``) is the original but for its docstrings (``ast``);
* the generators, ``process_text_only``, merge/balance, the spell corrector
  and the heuristic color backend give the original's rows and words on the
  annotations and words of ``tests/test_creation.py``;
* ``cli/create_dataset.py`` on that file's synthetic SUNRGBD toolbox tree
  writes every per-type CSV and every final split CSV equal, file by file,
  to the JAX CLI's on the same tree and seed, with ``--no_spellcheck`` and
  with the default spell check, heuristic color backend;
* a color backend that raises fails the port's CLI (the JAX CLI counts it as
  a tolerated per-item error and exits normally: the reference fault the
  port does not carry over);
* ``cli/dataset_statistics.py`` prints what the JAX CLI prints."""

import ast
import json
import os
import random

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

import knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu as jpkg
import knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch as ppkg
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.cli import (
    create_dataset as jax_create,
    dataset_statistics as jax_stats,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.data.creation import (
    color_backend as jcb,
    merge as jmerge,
    postprocess as jpost,
    questions as jq,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.utils import (
    spelling as jspell,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli import (
    common,
    create_dataset,
    dataset_statistics,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.data.creation import (
    color_backend as pcb,
    merge as pmerge,
    postprocess as ppost,
    questions as pq,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.utils import (
    spelling as pspell,
)
from tests.test_creation import _ann, _poly

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's tests of this slice run many small ops.  Beside the
    suite's other workers a full intra-op thread pool in each process
    oversubscribes the cores (the workflow test took 147 s so against 11 s
    on one thread), so they run on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def offline_spell_stage(monkeypatch):
    """Both packages' spell stages as they resolve without the learned HF
    model's snapshot (none is in the repository): the native corrector and no
    HF stage, pinned so that no test resolves the model's hub id."""
    for post, spell in ((ppost, pspell), (jpost, jspell)):
        monkeypatch.setattr(post, "_spell_fixers", lambda hf_model=None, _fix=spell.correct_word: (_fix, None))


COPIES = [f"data/creation/{m}.py" for m in ("__init__", "geometry", "prominent", "postprocess", "questions",
                                             "merge", "extract", "color_backend")] + \
    ["utils/spelling.py", "eval/statistics.py"]


def _strip_docstrings(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef)) and node.body and \
                isinstance(node.body[0], ast.Expr) and isinstance(node.body[0].value, ast.Constant) and \
                isinstance(node.body[0].value.value, str):
            node.body = node.body[1:]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", COPIES)
def test_copies_are_the_originals_but_for_docstrings(rel):
    got, want = (_strip_docstrings(ast.parse(open(os.path.join(os.path.dirname(pkg.__file__), rel)).read()))
                 for pkg in (ppkg, jpkg))
    assert got == want


# The annotations of tests/test_creation.py: its generator, prominence and
# CLI-tree cases.
ANNOTATIONS = {
    "generators": _ann(["chair", "chair", "lamp"], [
        _poly(0, [0, 0, 50, 50], [0, 40, 40, 0]),
        _poly(1, [60, 60, 70, 70], [0, 5, 5, 0]),
        _poly(2, [100, 100, 104, 104], [0, 3, 3, 0]),
    ]),
    "dominant": _ann(["chair", "bed", "wall"], [
        _poly(0, [0, 0, 10, 10], [0, 1, 1, 0]),
        _poly(1, [0, 0, 100, 100], [0, 10, 10, 0]),
        _poly(2, [0, 0, 500, 500], [0, 500, 500, 0]),
    ]),
    "depth_tiebreak": _ann(["chair", "table", "sofa"], [
        _poly(0, [0, 0, 10, 10], [0, 10, 10, 0], z=[1.0, 1.0, 1.0]),
        _poly(1, [0, 0, 11, 11], [0, 10, 10, 0], z=[5.0, 5.0, 5.0]),
        _poly(2, [0, 0, 9.5, 9.5], [0, 10, 10, 0], z=[2.0, 2.0, 2.0]),
    ]),
    "all_filtered": _ann(["wall", "floor"], [_poly(0, [0, 0, 1, 1], [0, 1, 1, 0])]),
    "cli_tree": _ann(["chair", "table", "lamp", "bed"], [
        _poly(j, [10 * j, 10 * j, 10 * j + 8 + j, 10 * j + 8 + j], [0, 8, 8, 0]) for j in range(4)
    ]),
}


@pytest.mark.parametrize("spell", [False, True])
@pytest.mark.parametrize("name", sorted(ANNOTATIONS))
def test_generators_give_the_originals_rows(name, spell):
    ann = ANNOTATIONS[name]
    for fn in ("object_identification_row", "count_row", "proximity_rows", "direction_row"):
        assert getattr(pq, fn)(ann, enable_spellcheck=spell) == getattr(jq, fn)(ann, enable_spellcheck=spell), fn
    items = ["chair", "sofa", "lamp"]
    assert pq.yes_no_rows(ann, items, random.Random(0), enable_spellcheck=spell) == \
        jq.yes_no_rows(ann, items, random.Random(0), enable_spellcheck=spell)
    img = np.random.default_rng(0).integers(0, 255, (40, 120, 3)).astype(np.uint8)
    assert pq.color_row(ann, img, pcb.heuristic_color_vqa, enable_spellcheck=spell) == \
        jq.color_row(ann, img, jcb.heuristic_color_vqa, enable_spellcheck=spell)


WORDS = ["nightstand", "nightstand3", "3 chairs", "Lamp12", "3 chiars", "garbagebin", "tabel", "", "n/a"]


@pytest.mark.parametrize("spell", [False, True])
def test_process_text_only_gives_the_originals_words(spell):
    for w in WORDS:
        assert ppost.process_text_only(w, enable_spellcheck=spell) == \
            jpost.process_text_only(w, enable_spellcheck=spell), w
    assert ppost.clean_and_dedupe(["chair", "chair", "Lamp2", "n/a"]) == \
        jpost.clean_and_dedupe(["chair", "chair", "Lamp2", "n/a"])


def test_spell_corrector_gives_the_originals_words():
    for w in ["chiar", "tabel", "lmap", "pilow", "florr", "chair", "Chair", "42", "", "blu", "xqzt"]:
        assert pspell.correct_word(w) == jspell.correct_word(w), w
    assert pspell.correct_text("the chiar is blu") == jspell.correct_text("the chiar is blu")


def test_merge_and_balance_give_the_originals_frames():
    rows = []
    for i in range(8):
        rows.append({"Questions": "What is the most prominent object?", "Answers": "hair" if i == 0 else "chair",
                     "Image_Path": f"img{i}.png", "Depth_Path": f"d{i}.png",
                     "Question_Type": "Object Identification"})
        rows.append({"Questions": "Is there any chair?", "Answers": "yes" if i % 2 == 0 else "no",
                     "Image_Path": f"img{i}.png", "Depth_Path": f"d{i}.png", "Question_Type": "Yes/No"})
    rows.append({"Questions": "What is wall40?", "Answers": "wall40", "Image_Path": "imgx.png",
                 "Depth_Path": "dx.png", "Question_Type": "Object Identification"})
    df = pd.DataFrame(rows)
    for split in ("validation", "train"):
        pd.testing.assert_frame_equal(pmerge.process_split([df.copy()], split),
                                      jmerge.process_split([df.copy()], split))
    for got, want in zip(pmerge.split_70_20_10(df), jmerge.split_70_20_10(df)):
        pd.testing.assert_frame_equal(got, want)


def write_toolbox_tree(root, splits=(("validation", 8, 0),), size=(40, 60)):
    """tests/test_creation.py's synthetic toolbox tree (its CLI test's frames,
    four named objects with polygons each), one split per (name, frames,
    seed): RGB PNGs, uint16 depth PNGs, annotation JSONs and the
    ``splits_output_paths/<split>/`` lists."""
    os.makedirs(os.path.join(root, "SUNRGBD", "img"), exist_ok=True)
    for split, n, seed in splits:
        rng = np.random.default_rng(seed)
        sp = os.path.join(root, "splits_output_paths", split)
        os.makedirs(sp, exist_ok=True)
        lists = {"all_rgb.txt": [], "all_depth.txt": [], "annotations.txt": []}
        for i in range(n):
            rgb, depth, ann = (f"SUNRGBD/img/{split}_{kind}_{i}.{ext}"
                               for kind, ext in (("rgb", "png"), ("d", "png"), ("ann", "json")))
            Image.fromarray(rng.integers(0, 255, size + (3,)).astype(np.uint8)).save(os.path.join(root, rgb))
            Image.fromarray(rng.integers(0, 65535, size).astype(np.uint16)).save(os.path.join(root, depth))
            with open(os.path.join(root, ann), "w") as f:
                json.dump(ANNOTATIONS["cli_tree"], f)
            for k, v in zip(lists, (rgb, depth, ann)):
                lists[k].append(v)
        for k, v in lists.items():
            with open(os.path.join(sp, k), "w") as f:
                f.write("\n".join(v))
    return str(root)


def csv_files(root):
    """Every CSV the CLI wrote under ``root``: relative path -> bytes."""
    base = os.path.join(root, "SUNRGBD", "csv_data")
    return {os.path.relpath(os.path.join(d, f), base): open(os.path.join(d, f), "rb").read()
            for d, _, fs in os.walk(base) for f in fs if f.endswith(".csv")}


# tests/test_creation.py's CLI tree: 8 validation frames; here a 6-frame
# train split (another seed) beside it, so the floor/wall caps' counters and
# the yes/no rng run across splits
SPLITS = (("train", 6, 1), ("validation", 8, 0))
PER_TYPE = {"object_identification.csv", "count.csv", "yes_no.csv", "proximity.csv", "direction.csv",
            "color.csv"}


@pytest.mark.parametrize("flags", [["--no_spellcheck"], [], ["--no_spellcheck", "--seed", "7", "--max_items", "5"]])
def test_create_dataset_csvs_equal_the_jax_clis(tmp_path, flags, capsys):
    outs = {}
    for name, cli in (("jax", jax_create), ("port", create_dataset)):
        root = write_toolbox_tree(tmp_path / name, SPLITS)
        capsys.readouterr()
        cli.main(["--root_data_dir", root, "--splits", "train", "validation", *flags])
        outs[name] = (csv_files(root), capsys.readouterr().out)
    (got, got_out), (want, want_out) = outs["port"], outs["jax"]
    assert sorted(got) == sorted(want)
    for split, final in (("train", "train_dataset.csv"), ("validation", "val_dataset.csv")):
        assert {os.path.basename(k) for k in want if k.startswith(f"individual_datasets/{split}/")} == PER_TYPE
        assert final in want
    for rel in want:
        assert got[rel] == want[rel], rel
    assert got_out == want_out
    assert got_out.count(" rows, 0 errors") == 2, got_out


def test_a_raising_color_backend_fails_the_cli(tmp_path, monkeypatch, capsys):
    def broken(image, question, crop=None):
        raise RuntimeError("the backend cannot run")

    monkeypatch.setattr(pcb, "heuristic_color_vqa", broken)
    monkeypatch.setattr(jcb, "heuristic_color_vqa", broken)
    root = write_toolbox_tree(tmp_path / "port")
    with pytest.raises(create_dataset.ColorBackendError, match="the backend cannot run"):
        create_dataset.main(["--root_data_dir", root, "--splits", "validation", "--no_spellcheck"])
    assert not os.path.exists(os.path.join(root, "SUNRGBD", "csv_data", "val_dataset.csv"))
    # the reference's fault: the JAX CLI swallows it, one error an item
    root = write_toolbox_tree(tmp_path / "jax")
    capsys.readouterr()
    jax_create.main(["--root_data_dir", root, "--splits", "validation", "--no_spellcheck"])
    out = capsys.readouterr().out
    assert "validation: 48 rows, 8 errors" in out, out
    assert not os.path.exists(os.path.join(root, "SUNRGBD", "csv_data", "individual_datasets", "validation",
                                           "color.csv"))


@pytest.fixture(scope="module")
def stats_root(tmp_path_factory):
    return common.ensure_synthetic_dataset(str(tmp_path_factory.mktemp("stats")), n=40)


@pytest.mark.parametrize("flags", [
    [], ["--gts_type", "train", "--accuracy", "0.45"], ["--accuracy", "0.3", "--n", "200", "--confidence", "0.9"],
    ["--gts_type", "test", "--seed", "3", "--accuracy", "0.5", "--confidence", "0.97"],
])
def test_dataset_statistics_prints_what_the_jax_cli_prints(stats_root, flags, capsys):
    outs = []
    for cli in (jax_stats, dataset_statistics):
        capsys.readouterr()
        cli.main(["--root_data_dir", stats_root, *flags])
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "random-guess baseline" in outs[0]
    assert ("CI for accuracy" in outs[0]) == ("--accuracy" in flags)
