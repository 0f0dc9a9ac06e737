"""The port's ``cli/convert_weights.py`` and its decode against HF, on the
CPU, on ``tests/test_convert_cli.py``'s random tiny HF LLaVA-OneVision
(saved with ``save_pretrained`` as safetensors; nothing is downloaded):

* the CLI's file holds a state dict equal, leaf by leaf, to
  ``params_from_flax`` of the JAX ``load_llava_onevision_params`` on the same
  snapshot, in float32 and in bfloat16 (the JAX CLI's cast), and prints the
  JAX CLI's parameter count;
* the inference CLI restores that file with ``--student_ckpt_path``, and
  ``load_student_for_eval`` finds it in its directory;
* the port's ``Generator`` is token-equal to HF ``generate`` at
  (repetition_penalty, no_repeat_ngram_size) = (1.2, 2) and (1.0, 0), as
  ``tests/test_decode_hf_parity.py`` holds the JAX ``Generator``.

The CLI takes ``--model_size 0.5b|7b``; the tests point ``0.5b`` at the tiny
config (``convert_weights.CONFIGS``)."""

import os

import numpy as np
import pytest
import torch

pytest.importorskip("transformers")
pytest.importorskip("safetensors")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.configs import (  # noqa: E402
    llava_onevision_tiny as jax_tiny,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.models.convert import (  # noqa: E402
    load_llava_onevision_params as jax_load,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch import configs  # noqa: E402
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli import (  # noqa: E402
    common,
    convert_weights,
    inference,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.eval import runner  # noqa: E402
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.eval.decode import (  # noqa: E402
    GenerateConfig,
    Generator,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.models.convert import (  # noqa: E402
    convert_hf_state_dict,
    params_from_flax,
)
from tests.test_convert_cli import _tiny_hf_model  # noqa: E402
from tests.test_torch_creation import one_torch_thread  # noqa: E402,F401

CFG = configs.llava_onevision_tiny()


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    hf = _tiny_hf_model()
    snap = tmp_path_factory.mktemp("snapshot")
    hf.save_pretrained(snap, safe_serialization=True)
    assert any(f.endswith(".safetensors") for f in os.listdir(snap))
    return str(snap)


@pytest.fixture
def tiny_size(monkeypatch):
    monkeypatch.setitem(convert_weights.CONFIGS, "0.5b", configs.llava_onevision_tiny)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_converted_file_equals_the_jax_conversion(snapshot, tiny_size, tmp_path, dtype, capsys):
    out = str(tmp_path / "ck" / "converted.ckpt")
    convert_weights.main(["--hf_snapshot", snapshot, "--output", out, "--dtype", dtype])
    params = jax_load(snapshot, jax_tiny())
    if dtype == "bfloat16":
        params = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), params)
    want = params_from_flax(params, CFG)
    got = torch.load(out, weights_only=True)
    assert sorted(got) == ["params"]
    got = got["params"]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == getattr(torch, dtype), k
        torch.testing.assert_close(got[k].float(), v, rtol=0, atol=0, msg=k)
    n = sum(x.size for x in jax.tree.leaves(params))
    assert capsys.readouterr().out.strip() == f"converted {n/1e9:.3f}B params -> {out}"


def test_the_clis_restore_the_converted_file(snapshot, tiny_size, tmp_path, capsys):
    ckdir = tmp_path / "ck"
    out = str(ckdir / "converted.ckpt")
    convert_weights.main(["--hf_snapshot", snapshot, "--output", out])
    want = torch.load(out, weights_only=True)["params"]
    flags = ["--synthetic_data", "--cpu", "--root_data_dir", str(tmp_path / "d"), "--max_new_tokens", "4",
             "--student_ckpt_path", out]
    capsys.readouterr()
    inference.main(flags)
    printed = capsys.readouterr().out
    assert f"loaded student params from {out}" in printed and "Model_Answer" in printed
    model = common.load_student(inference.build_parser().parse_args(flags), CFG, torch.device("cpu"))
    answer = runner.load_student_for_eval(str(ckdir), tiny=True, cpu=True)
    for restored in (model.state_dict(), answer.__self__.model.state_dict()):
        assert sorted(restored) == sorted(want)
        for k, v in want.items():
            torch.testing.assert_close(restored[k], v, rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("rep_penalty,ngram", [(1.2, 2), (1.0, 0)])
def test_greedy_decode_matches_hf_generate(rep_penalty, ngram):
    """``tests/test_decode_hf_parity.py``'s case: text-only prompts on the
    converted tiny model isolate the decode chain (embeddings, LM, cache,
    penalties, argmax) from the image path."""
    hf = _tiny_hf_model().eval()
    model = common.init_or_load_params(CFG, None, 0, attn_impl="xla", device=torch.device("cpu"),
                                       dtype=torch.float32)
    model.load_state_dict(params_from_flax(convert_hf_state_dict(dict(hf.state_dict()), CFG), CFG))

    rng = np.random.default_rng(11)
    b, s, new = 2, 24, 8
    # plain text ids only: clear of the image/video/pad specials
    ids = rng.integers(5, CFG.text.vocab_size - 10, size=(b, s)).astype(np.int64)
    mask = np.ones((b, s), np.int64)
    with torch.no_grad():
        hf_out = hf.generate(input_ids=torch.tensor(ids), attention_mask=torch.tensor(mask), max_new_tokens=new,
                             do_sample=False, repetition_penalty=rep_penalty,
                             no_repeat_ngram_size=ngram if ngram else None, eos_token_id=None, pad_token_id=0)
    want = hf_out.numpy()[:, s:]

    gen = Generator(CFG, GenerateConfig(max_new_tokens=new, repetition_penalty=rep_penalty,
                                        no_repeat_ngram_size=ngram, eos_token_id=-1))  # eos unreachable
    out = gen.generate(model, {"student_input_ids": torch.tensor(ids), "student_attention_mask": torch.tensor(mask)})
    got = out["sequences"].numpy()[:, s:s + new]
    np.testing.assert_array_equal(got, want)
