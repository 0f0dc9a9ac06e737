"""The port's legacy loaders (``data/legacy.py``, a copy of the JAX
package's over the port's ``data/dataset.py``) against the originals: the
module is the original but for its docstring (``ast``), and on a seeded
synthetic SUNRGBD tree both Florence loaders (augmented with a seed, and
plain) and the BERT-tokenized loader give the same items.  The JAX
dataset's Prewitt encoding runs on the library ``native/build.sh``'s
command builds (in a temporary directory), as the port's does."""

import ast
import inspect
import subprocess

import numpy as np
import pytest

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.cli.common import (
    ensure_synthetic_dataset,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.data import legacy as jax_legacy
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.data import native as jax_native
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.data.tokenization import (
    HashTokenizer as JaxHashTokenizer,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.data import legacy, native
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.data.tokenization import (
    HashTokenizer,
)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return ensure_synthetic_dataset(str(tmp_path_factory.mktemp("tree")), n=12, seed=0)


@pytest.fixture
def jax_on_native(tmp_path, monkeypatch):
    out = tmp_path / "libdepthops.so"
    subprocess.run(["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC", str(native.SOURCE), "-o",
                    str(out)], check=True, capture_output=True)
    monkeypatch.setattr(jax_native, "_LIB_PATH", str(out))
    monkeypatch.setattr(jax_native, "_lib", None)


def _body(module):
    tree = ast.parse(inspect.getsource(module))
    tree.body = tree.body[1:]  # the docstring
    return ast.dump(tree)


def test_the_copy_is_the_original_but_for_its_docstring():
    assert _body(legacy) == _body(jax_legacy)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


@pytest.mark.parametrize("augmentation", [True, False])
def test_florence_items_equal_the_original(tree, augmentation):
    got_ds = legacy.FlorenceSUNRGBDDataset(tree, "train_dataset.csv", augmentation=augmentation, seed=3)
    want_ds = jax_legacy.FlorenceSUNRGBDDataset(tree, "train_dataset.csv", augmentation=augmentation, seed=3)
    assert len(got_ds) == len(want_ds) > 0
    for i in range(len(got_ds)):  # in order: the augmentation draws from one stream
        _same(got_ds[i], want_ds[i])


def test_bert_items_equal_the_original(tree, jax_on_native):
    got_ds = legacy.BertVQADataset(tree, "val_dataset.csv", HashTokenizer(), max_len=16)
    want_ds = jax_legacy.BertVQADataset(tree, "val_dataset.csv", JaxHashTokenizer(), max_len=16)
    assert len(got_ds) == len(want_ds) > 0
    for i in range(len(got_ds)):
        got = got_ds[i]
        assert got[0].shape == (16,) and got[0].dtype == np.int32
        _same(got, want_ds[i])
