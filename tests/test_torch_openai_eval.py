"""The port's hosted-model depth evaluation (``cli/openai_eval_depth.py``)
against the JAX package's, on the CPU.  Nothing is sent: a stub ``openai``
module stands in ``sys.modules`` (the package is not installed), with a
dummy key.

* ``depth_images_for_eval``: both PNGs byte for byte equal to the JAX
  function's, for seeded depth frames and a constant one;
* the gate: without ``openai`` and without ``OPENAI_API_KEY``, the JAX
  CLI's ``SystemExit`` messages;
* with the stub, the two CSVs of both CLIs equal file by file, and the
  stub's requests equal (model, prompt, both encodings of every row); the
  device and mesh flags are parsed and not read."""

import base64
import hashlib
import os
import sys
import types

import numpy as np
import pytest

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.cli import (
    openai_eval_depth as jax_openai,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli import (
    common,
    openai_eval_depth,
)


def _depths():
    rng = np.random.default_rng(3)
    return [rng.integers(0, 65535, (45, 67)).astype(np.uint16), rng.integers(500, 4000, (30, 80)).astype(np.uint16),
            np.full((20, 20), 1234, np.uint16), rng.normal(2.0, 0.5, (16, 24)).astype(np.float32)]


def test_depth_images_equal_jax():
    for d in _depths():
        got, want = openai_eval_depth.depth_images_for_eval(d), jax_openai.depth_images_for_eval(d)
        assert got[0] == want[0] and got[1] == want[1]
        assert got[0][:8] == b"\x89PNG\r\n\x1a\n"


def _stub_openai(requests):
    """An ``openai`` module whose client answers from a hash of each
    request and records it."""
    mod = types.ModuleType("openai")

    def create(model, messages, max_tokens):
        requests.append((model, messages, max_tokens))
        text = messages[0]["content"][0]["text"]
        url = messages[0]["content"][1]["image_url"]["url"]
        png = base64.b64decode(url.split(",", 1)[1])
        digest = hashlib.sha1(png).hexdigest()[:6]
        msg = types.SimpleNamespace(content=f"  {text.split(' Answer')[0].split()[-1].upper()} {digest} ")
        return types.SimpleNamespace(choices=[types.SimpleNamespace(message=msg)])

    class OpenAI:
        def __init__(self):
            self.chat = types.SimpleNamespace(completions=types.SimpleNamespace(create=create))

    mod.OpenAI = OpenAI
    return mod


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return common.ensure_synthetic_dataset(str(tmp_path_factory.mktemp("sunrgbd")))


def _argv(tree, preds, *flags):
    return ["--root_data_dir", tree, "--predictions_dir", str(preds), "--max_items", "5", *flags]


def test_the_gate_messages_equal_jax(tree, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "openai", None)  # import openai -> ImportError
    for main in (jax_openai.main, openai_eval_depth.main):
        with pytest.raises(SystemExit, match="openai package not installed .* set OPENAI_API_KEY"):
            main(_argv(tree, tmp_path / "p"))
    monkeypatch.setitem(sys.modules, "openai", _stub_openai([]))
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    monkeypatch.chdir(tmp_path)  # no .env here
    for main in (jax_openai.main, openai_eval_depth.main):
        with pytest.raises(SystemExit, match="^OPENAI_API_KEY not set$"):
            main(_argv(tree, tmp_path / "p"))
    assert not (tmp_path / "p").exists()


def test_stubbed_csvs_equal_jax(tree, tmp_path, monkeypatch):
    monkeypatch.setenv("OPENAI_API_KEY", "dummy")
    seen = {}
    for name, main, flags in (("jax", jax_openai.main, ()),
                              ("port", openai_eval_depth.main, ("--cpu", "--distributed", "--mesh", "2,1,1",
                                                                "--num_workers", "2", "--dataset", "daquar"))):
        requests = seen.setdefault(name, [])
        monkeypatch.setitem(sys.modules, "openai", _stub_openai(requests))
        main(_argv(tree, tmp_path / name, "--gts_type", "val", *flags))
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 10
    assert seen["port"][0][0] == "gpt-4o" and seen["port"][0][2] == 32
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == ["results_openai_depth1d_val.csv", "results_openai_depth3d_val.csv"]
    assert sorted(os.listdir(tmp_path / "port")) == names
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes(), n
    assert len((tmp_path / "port" / names[0]).read_text().splitlines()) == 1 + 5
