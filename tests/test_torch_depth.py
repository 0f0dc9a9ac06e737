"""The port's jax-free numpy depth encoders and SUNRGBD row reader are
bit-exact with the JAX package's."""

import numpy as np
import pytest

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.cli.common import (
    ensure_synthetic_dataset,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.data import (
    dataset as jax_dataset,
    depth as jax_depth,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.data import (
    dataset,
    depth,
)


def _depths():
    rng = np.random.default_rng(0)
    yield rng.integers(0, 65535, size=(53, 73)).astype(np.uint16)  # raw SUNRGBD-like
    yield rng.normal(size=(17, 9)).astype(np.float32) * 100.0
    yield np.zeros((6, 7), dtype=np.uint16)  # flat: the min == max guard
    ramp = np.tile(np.arange(40, dtype=np.uint16) * 1000, (30, 1))
    ramp[10:20, 10:20] = 0
    yield ramp


@pytest.mark.parametrize("bake", [False, True])
@pytest.mark.parametrize("i", range(4))
def test_prewitt_bit_exact(i, bake):
    d = list(_depths())[i]
    want = jax_depth.depth_to_3ch_numpy(d, imagenet_bake=bake)
    got = depth.depth_to_3ch_numpy(d, imagenet_bake=bake)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("i", range(4))
def test_gray3_bit_exact(i):
    d = list(_depths())[i]
    np.testing.assert_array_equal(depth.depth_to_gray3_numpy(d), jax_depth.depth_to_gray3_numpy(d))


@pytest.mark.parametrize("encoding", ["prewitt", "gray3", "prewitt_imagenet"])
def test_dataset_rows_match_jax(tmp_path, encoding):
    root = ensure_synthetic_dataset(str(tmp_path), n=4, seed=2)
    want_ds = jax_dataset.SUNRGBDVQADataset(root, "val_dataset.csv", 0.5, depth_encoding=encoding)
    got_ds = dataset.SUNRGBDVQADataset(root, "val_dataset.csv", 0.5, depth_encoding=encoding)
    assert len(got_ds) == len(want_ds) == 2
    for i in range(2):
        want, got = want_ds[i], got_ds[i]
        assert got[0] == want[0] and got[1] == want[1] and got[4] == want[4]
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_array_equal(got[3], want[3])


def test_dataset_rejects_unknown_encoding(tmp_path):
    root = ensure_synthetic_dataset(str(tmp_path), n=2)
    with pytest.raises(ValueError):
        dataset.SUNRGBDVQADataset(root, "val_dataset.csv", depth_encoding="sobel")
