"""The port's native depth encoding (``data/native.py``, ``native/depth_ops.cc``
built at first use into ``build/native/``) against the JAX package's
``data/native.py`` and the numpy encoding.

* Against the JAX ``depth_to_3ch_native`` on the library its own
  ``native/build.sh`` command builds (into a temporary directory here, so
  the test neither needs nor writes ``native/libdepthops.so``): bit-exact
  on every input, both ``imagenet_bake`` values, odd H x W, all-zero and
  NaN depth, and full SUNRGBD frames; and the port's dataset rows equal
  the JAX dataset's on that library, for both Prewitt encodings.
* Against the numpy encoding (``data/depth.py``, the plain version):
  bit-exact on odd shapes, all-zero and constant depth and the JAX
  ``tests/test_native.py`` frames.  On random 530 x 730 uint16 frames the
  C++ ``atan2f`` and numpy's ``arctan2`` can differ by one ulp, which the
  normalize-and-truncate turns into a byte off by exactly 1 in the
  direction channel (2 after the ImageNet bake, whose affine map and
  second truncation can put the two bytes on either side of one more
  integer): the test holds 20 such frames to that (channel 2 only,
  |diff| <= 1, or 2 baked, at most 1e-4 of the channel's bytes).  NaN depth is
  held only against the JAX native library: numpy's min and max propagate
  NaN and then cast NaN to uint8, which is undefined, where the C++ min
  and max skip it.
* A build that fails raises with the compiler's output, and
  ``native_available`` then says False.
"""

import subprocess

import numpy as np
import pytest

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.cli.common import (
    ensure_synthetic_dataset,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.data import (
    dataset as jax_dataset,
    depth as jax_depth,
    native as jax_native,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.data import (
    dataset,
    depth,
    native,
)


@pytest.fixture(scope="module")
def jax_library(tmp_path_factory):
    """``native/build.sh``'s build of the source, in a temporary directory."""
    out = tmp_path_factory.mktemp("jax_native") / "libdepthops.so"
    subprocess.run(["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC", str(native.SOURCE), "-o",
                    str(out)], check=True, capture_output=True)
    return str(out)


@pytest.fixture
def jax_on_library(jax_library, monkeypatch):
    """The JAX ``depth_to_3ch_native`` on that library."""
    monkeypatch.setattr(jax_native, "_LIB_PATH", jax_library)
    monkeypatch.setattr(jax_native, "_lib", None)
    assert jax_native.native_available()
    return jax_native.depth_to_3ch_native


def _frames():
    rng = np.random.default_rng(0)
    return {
        "odd 31x47": rng.integers(0, 65535, (31, 47)).astype(np.uint16),
        "odd 1x5": rng.integers(0, 65535, (1, 5)).astype(np.uint16),
        "odd 129x3": rng.normal(size=(129, 3)).astype(np.float32) * 100.0,
        "zero": np.zeros((9, 11), np.uint16),
        "constant": np.full((20, 20), 7, np.uint16),
    }


def _nan_frame():
    rng = np.random.default_rng(1)
    d = (rng.random((13, 17)) * 10.0).astype(np.float32)
    d[rng.random((13, 17)) < 0.1] = np.nan
    return d


def _sunrgbd_frames(n=3):
    return [np.random.default_rng(s).integers(0, 65535, (530, 730)).astype(np.uint16) for s in range(n)]


@pytest.mark.parametrize("bake", [False, True])
def test_native_equals_the_jax_native(bake, jax_on_library):
    cases = list(_frames().values()) + [_nan_frame()] + _sunrgbd_frames()
    for d in cases:
        got = native.depth_to_3ch_native(d, imagenet_bake=bake)
        assert got.dtype == np.uint8 and got.shape == d.shape + (3,)
        np.testing.assert_array_equal(got, jax_on_library(d, imagenet_bake=bake))


@pytest.mark.parametrize("bake", [False, True])
@pytest.mark.parametrize("name", sorted(_frames()))
def test_native_equals_the_numpy_encoding(name, bake):
    d = _frames()[name]
    want = depth.depth_to_3ch_numpy(d, imagenet_bake=bake)
    np.testing.assert_array_equal(native.depth_to_3ch_native(d, imagenet_bake=bake), want)
    np.testing.assert_array_equal(want, jax_depth.depth_to_3ch_numpy(d, imagenet_bake=bake))


def test_native_equals_numpy_on_the_jax_frames():
    """The frames of the JAX ``tests/test_native.py::test_native_bit_exact``."""
    rng = np.random.default_rng(0)
    for shape in [(30, 40), (45, 67), (530, 730)]:
        d = rng.integers(0, 65535, shape).astype(np.uint16)
        np.testing.assert_array_equal(native.depth_to_3ch_native(d), depth.depth_to_3ch_numpy(d))


@pytest.mark.parametrize("bake", [False, True])
def test_native_differs_from_numpy_only_by_an_atan2_ulp(bake):
    worst = 0
    for s in range(20):
        d = np.random.default_rng(s).integers(0, 65535, (530, 730)).astype(np.uint16)
        got = native.depth_to_3ch_native(d, imagenet_bake=bake).astype(np.int16)
        want = depth.depth_to_3ch_numpy(d, imagenet_bake=bake).astype(np.int16)
        diff = np.argwhere(got != want)
        assert set(diff[:, 2].tolist()) <= {2}, f"seed {s}: channels {set(diff[:, 2].tolist())}"
        assert np.abs(got - want).max() <= (2 if bake else 1)
        worst = max(worst, len(diff))
    assert worst <= 1e-4 * 530 * 730, worst


@pytest.mark.parametrize("encoding", ["prewitt", "prewitt_imagenet"])
def test_dataset_rows_take_the_native_encoding(tmp_path, encoding, jax_on_library):
    root = ensure_synthetic_dataset(str(tmp_path), n=12, seed=0)
    got_ds = dataset.SUNRGBDVQADataset(root, "train_dataset.csv", depth_encoding=encoding)
    want_ds = jax_dataset.SUNRGBDVQADataset(root, "train_dataset.csv", depth_encoding=encoding)
    assert len(got_ds) == len(want_ds) > 0
    for i in range(len(got_ds)):
        got = got_ds[i]
        np.testing.assert_array_equal(got[3], want_ds[i][3])
        from PIL import Image

        raw = np.array(Image.open(got_ds.image_paths(i)[1]))
        np.testing.assert_array_equal(got[3], native.depth_to_3ch_native(raw, encoding == "prewitt_imagenet"))


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "depth_ops.cc"
    bad.write_text('extern "C" void depth_to_3ch( { this is not C++ }\n')
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="error"):
            native.depth_to_3ch_native(np.zeros((4, 4), np.uint16))
        assert not native.native_available()
        assert not list((tmp_path / "build").glob("*.so"))
    finally:
        native.load_library.cache_clear()


def test_the_library_is_keyed_by_its_source(tmp_path, monkeypatch):
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.name.startswith("libdepthops_")
    edited = tmp_path / "depth_ops.cc"
    edited.write_text(native.SOURCE.read_text() + "\n// edited\n")
    monkeypatch.setattr(native, "SOURCE", edited)
    assert native.library_path() != path
