"""The port's inference CLI on the CPU (bf16 and int8 serving, a checkpoint
of the port's train CLI), its refusal of a missing checkpoint, and its
freedom from jax."""

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


def test_inference_cli_restores_a_port_checkpoint(tmp_path, capsys, monkeypatch):
    """``--student_ckpt_path`` with a checkpoint that the port's train CLI
    wrote: the served model's weights are the checkpoint's."""
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli import train

    train.main(["--synthetic_data", "--cpu", "--accumulate_grad_batches", "1", "--num_workers", "1",
                "--root_data_dir", str(tmp_path / "d"), "--checkpoint_dir", str(tmp_path / "ck"),
                "--tensorboard_dir", str(tmp_path / "tb")])
    (ckpt,) = [os.path.join(r, f) for r, _, fs in os.walk(tmp_path / "ck") for f in fs if f.endswith(".ckpt")]
    capsys.readouterr()
    built = []
    init = common.init_or_load_params
    monkeypatch.setattr(common, "init_or_load_params", lambda *a, **kw: built.append(init(*a, **kw)) or built[-1])
    inference.main(["--synthetic_data", "--cpu", "--max_new_tokens", "4", "--root_data_dir", str(tmp_path / "d"),
                    "--seed", "3", "--student_ckpt_path", ckpt])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == f"loaded student params from {ckpt}" and len(lines) == 3
    assert "what is the object number 0?" in lines[2]
    saved = torch.load(ckpt, weights_only=True)["params"]
    (model,) = built
    for name, value in model.state_dict().items():
        assert torch.equal(value, saved[name].to(value.dtype)), name


def test_inference_cli_refuses_a_missing_checkpoint(tmp_path):
    with pytest.raises(SystemExit, match="no such checkpoint file"):
        inference.main(["--synthetic_data", "--cpu", "--root_data_dir", str(tmp_path),
                        "--student_ckpt_path", str(tmp_path / "x" / "none.ckpt")])


def test_resolve_attn_impl():
    """The flash kernels on CUDA for the head dims they take (the backward's
    too for a model that trains), the plain path otherwise; ``--attn_impl``
    wins."""
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch import configs

    cpu, cuda = common.torch.device("cpu"), common.torch.device("cuda", 0)
    student, teacher, tiny = (configs.llava_onevision_0_5b(), configs.llava_onevision_7b(),
                              configs.llava_onevision_tiny())
    args = inference.build_parser().parse_args([])
    assert common.resolve_attn_impl(args, cpu, student) == "xla"
    assert common.resolve_attn_impl(args, cuda, student) == "flash"
    assert common.resolve_attn_impl(args, cuda, student, trainable=True) == "flash"
    assert common.resolve_attn_impl(args, cuda, teacher) == "flash"  # d = 128: a forward kernel only
    assert common.resolve_attn_impl(args, cuda, teacher, trainable=True) == "xla"
    assert common.resolve_attn_impl(args, cuda, tiny) == "xla"
    args = inference.build_parser().parse_args(["--attn_impl", "flash"])
    assert common.resolve_attn_impl(args, cpu, tiny) == "flash"


def test_resolve_ce_impl():
    """``TrainConfig.ce_impl`` as the CLIs choose it: the fused kernels on
    CUDA for the 896-wide student, the plain chunked route on the CPU and
    for the tiny config."""
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch import configs

    cpu, cuda = common.torch.device("cpu"), common.torch.device("cuda", 0)
    assert common.resolve_ce_impl(cuda, configs.llava_onevision_0_5b()) == "fused"
    assert common.resolve_ce_impl(cpu, configs.llava_onevision_0_5b()) == "chunked"
    assert common.resolve_ce_impl(cuda, configs.llava_onevision_tiny()) == "chunked"


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
