"""The port's worker-process pipeline (``data/grain_pipeline.py``, on
``torch.utils.data.DataLoader``) against the JAX package's Grain loader:
with ``shuffle=False`` the batches are equal, key for key and bit for bit,
read in this process and in two spawned workers, over one epoch and over
three (micro-batches that span two epochs, the last partial one dropped,
leftover accumulation groups flushed largest bucket first); with
``shuffle=True`` one seed gives one order, every sample once an epoch.
The source is the port's SUNRGBD dataset on a synthetic tree (a module the
spawned workers can import), the JAX side its own dataset on the same tree
with the Prewitt encoding on the library ``native/build.sh``'s command
builds, as the port's is."""

import subprocess

import numpy as np
import pytest

pytest.importorskip("grain")

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.cli.common import (  # noqa: E402
    ensure_synthetic_dataset,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.configs import (  # noqa: E402
    llava_onevision_tiny as jax_tiny,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.data import (  # noqa: E402
    native as jax_native,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.data.collate import (  # noqa: E402
    OneVisionCollator as JaxCollator,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.data.dataset import (  # noqa: E402
    SUNRGBDVQADataset as JaxDataset,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.data.grain_pipeline import (  # noqa: E402
    make_grain_loader as jax_make_grain_loader,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.data.tokenization import (  # noqa: E402
    HashTokenizer as JaxHashTokenizer,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.configs import (  # noqa: E402
    llava_onevision_tiny,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.data import native  # noqa: E402
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.data.collate import (  # noqa: E402
    OneVisionCollator,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.data.dataset import (  # noqa: E402
    SUNRGBDVQADataset,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.data.grain_pipeline import (  # noqa: E402
    make_grain_loader,
    micro_batch_groups,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.data.tokenization import (  # noqa: E402
    HashTokenizer,
)

BUCKETS = (256, 512)


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


def _port(tree, **kw):
    cfg = llava_onevision_tiny()
    tok = HashTokenizer(pad_token_id=cfg.pad_token_id, image_token_id=cfg.image_token_id)
    return list(make_grain_loader(SUNRGBDVQADataset(tree, "train_dataset.csv"),
                                  OneVisionCollator(cfg, tok, buckets=BUCKETS), **kw))


def _jax(tree, **kw):
    cfg = jax_tiny()
    tok = JaxHashTokenizer(pad_token_id=cfg.pad_token_id, image_token_id=cfg.image_token_id)
    return list(jax_make_grain_loader(JaxDataset(tree, "train_dataset.csv"),
                                      JaxCollator(cfg, tok, buckets=BUCKETS), **kw))


def _equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("read_threads", [0, 2])
def test_batches_equal_the_grain_loader(tree, jax_on_native, read_threads):
    kw = dict(batch_size=2, accum=2, shuffle=False)
    got = _port(tree, read_threads=read_threads, **kw)
    _equal(got, _jax(tree, read_threads=2, **kw))
    assert got[0]["student_input_ids"].shape[:2] == (2, 2)


def test_epochs_span_micro_batches_as_grain_does(tree, jax_on_native):
    kw = dict(batch_size=5, accum=2, shuffle=False, num_epochs=3)
    _equal(_port(tree, read_threads=0, **kw), _jax(tree, read_threads=2, **kw))


def test_a_seed_gives_one_order():
    a = micro_batch_groups(12, 2, True, 5, 3)
    assert a == micro_batch_groups(12, 2, True, 5, 3)
    assert a != micro_batch_groups(12, 2, True, 6, 3)
    flat = [i for g in a for i in g]
    for e in range(3):
        assert sorted(flat[12 * e:12 * (e + 1)]) == list(range(12))
    assert micro_batch_groups(7, 2, False, 0, 1) == [[0, 1], [2, 3], [4, 5]]


def test_shuffled_batches_repeat_under_one_seed(tree):
    kw = dict(batch_size=2, accum=1, shuffle=True, seed=11, read_threads=0)
    first, second = _port(tree, **kw), _port(tree, **kw)
    _equal(first, second)
    ids = lambda bs: [b["student_input_ids"].tobytes() for b in bs]  # noqa: E731
    assert ids(first) != ids(_port(tree, batch_size=2, accum=1, shuffle=False, read_threads=0))
