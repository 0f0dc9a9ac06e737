"""The port's inference CLI on the CPU (bf16 and int8 serving), its refusals,
and its freedom from jax."""

import os
import subprocess
import sys

import pytest
import torch

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli import (
    common,
    inference,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch"


def test_inference_cli_prints_one_row(tmp_path, capsys):
    inference.main(["--synthetic_data", "--cpu", "--max_new_tokens", "4",
                    "--root_data_dir", str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    assert lines[0].split() == ["Question", "Ground_Truth", "Model_Answer"]
    assert "what is the object number 0?" in lines[1]


@pytest.mark.parametrize("quant", ["int8", "int8_full"])
def test_inference_cli_int8_prints_one_row(tmp_path, capsys, monkeypatch, quant):
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.models.qwen2 import (
        QLinear,
    )

    built = []
    init = common.init_or_load_params
    monkeypatch.setattr(common, "init_or_load_params", lambda *a, **kw: built.append(init(*a, **kw)) or built[-1])
    inference.main(["--synthetic_data", "--cpu", "--max_new_tokens", "4", "--quant", quant,
                    "--root_data_dir", str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and "what is the object number 0?" in lines[1]
    (model,) = built
    lm = model.language_model
    assert isinstance(lm.layers[0].mlp.down_proj, QLinear)
    assert isinstance(model.vision_tower.layers[0].mlp.fc1, QLinear) == (quant == "int8_full")
    assert isinstance(lm.embed_tokens, torch.nn.Embedding)  # the tied head stays float


@pytest.mark.parametrize("flags,match", [
    pytest.param(["--student_ckpt_path", "x/ckpt"], "checkpoint", id="flags1-checkpoint"),
])
def test_inference_cli_refuses_unported_options(flags, match):
    with pytest.raises(SystemExit, match=match):
        inference.main(["--synthetic_data", "--cpu", *flags])


def test_resolve_attn_impl():
    args = inference.build_parser().parse_args([])
    assert common.resolve_attn_impl(args, common.torch.device("cpu")) == "xla"
    assert common.resolve_attn_impl(args, common.torch.device("cuda", 0)) == "flash"
    args = inference.build_parser().parse_args(["--attn_impl", "flash"])
    assert common.resolve_attn_impl(args, common.torch.device("cpu")) == "flash"


def test_port_imports_no_jax():
    """A fresh process (this one has jax loaded by tests/conftest.py)."""
    code = (
        "import sys\n"
        f"import {PKG}, {PKG}.cli.inference, {PKG}.cli.common, {PKG}.eval.decode\n"
        f"import {PKG}.models, {PKG}.models.convert, {PKG}.ops.flash_attention\n"
        f"import {PKG}.ops._build, {PKG}.data.dataset\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',\n"
        f"    {PKG.removesuffix('_torch')!r}))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "ok"
