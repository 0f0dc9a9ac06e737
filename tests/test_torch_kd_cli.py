"""The port's online-KD CLI on the CPU: double_trouble phase 2 trains the
tiny student against the tiny teacher on the synthetic SUNRGBD tree and
writes its best checkpoint; phase 3 starts from it (the phase hand-off) and
writes its own; the three-phase chain 1 -> 2 -> 3 hands off twice, phase 1
moving only what it trains; logit_based, feature_based and the CLI's
default (double_trouble phase 1) run; phase 2 trains against the int8
teacher (``--teacher_quant int8`` and ``int8_full``); the faithful LoCa
(``--loca_faithful_indexing``) trains phase 2 and hands off to phase 3; and
``--dataset daquar`` trains on the synthetic DAQUAR tree."""

import math
import os
import re

import pytest
import torch

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli import (
    train_online_kd,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.train import (
    checkpoint,
)


def _run(tmp_path, *extra):
    return train_online_kd.main([
        "--synthetic_data", "--cpu", "--accumulate_grad_batches", "1", "--num_workers", "1",
        "--root_data_dir", str(tmp_path / "data"), "--checkpoint_dir", str(tmp_path / "ck"),
        "--tensorboard_dir", str(tmp_path / "tb"), *extra,
    ])


def _val_loss(out):
    val = [float(v) for v in re.findall(r"val_loss (\S+)", out)]
    assert len(val) == 1 and math.isfinite(val[0]), out[-2000:]
    return val[0]


def test_phase2_then_phase3_hands_off(tmp_path, capsys):
    _run(tmp_path, "--phase", "2")
    out = capsys.readouterr().out
    val2 = _val_loss(out)
    assert "training complete" in out and "phase hand-off" not in out
    dir2 = tmp_path / "ck" / "kd_double_trouble_phase2"
    best2 = checkpoint.find_best_checkpoint(str(dir2))
    assert best2 is not None and os.path.basename(best2) == checkpoint.checkpoint_name(0, val2)
    saved2 = checkpoint.CheckpointManager(str(dir2)).restore(best2)
    assert set(saved2) == {"params", "opt_state", "step"} and saved2["step"] == 12

    _run(tmp_path, "--phase", "3")
    out = capsys.readouterr().out
    assert f"phase hand-off: initialized from {best2}" in out
    assert "epoch 0 step 0 loss" in out  # AdamW and the step count start anew
    val3 = _val_loss(out)
    dir3 = tmp_path / "ck" / "kd_double_trouble_phase3"
    best3 = checkpoint.find_best_checkpoint(str(dir3))
    assert best3 is not None and os.path.basename(best3) == checkpoint.checkpoint_name(0, val3)
    assert checkpoint.CheckpointManager(str(dir3)).restore(best3)["step"] == 12


def test_params_only_restore_loads_the_weights_and_masters(tmp_path):
    """The hand-off's restore: a fresh bf16 model and optimizer take the
    checkpoint's weights and float32 masters; AdamW starts anew."""
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.train import (
        TrainState,
        make_optimizer,
    )

    def state(seed):
        torch.manual_seed(seed)
        model = torch.nn.Sequential(torch.nn.Linear(4, 3)).to(torch.bfloat16)
        return TrainState(model, make_optimizer(model, 1e-3))

    src = state(0)
    src.optimizer.apply({n: torch.ones_like(p, dtype=torch.float32)
                         for n, p in src.model.named_parameters()})
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    path = mgr.save(0, 1.0, {"params": src.model.state_dict(),
                             "opt_state": src.optimizer.state_dict(), "step": 1})
    dst = mgr.restore_params(path, state(1))
    for n, p in dst.model.named_parameters():
        assert torch.equal(p, src.model.state_dict()[n])
        assert torch.equal(dst.optimizer.masters[n], src.optimizer.masters[n])
    assert dst.optimizer.count == 0 and not dst.optimizer.opt.state


def test_logit_based_runs(tmp_path, capsys):
    _run(tmp_path, "--kd_mode", "logit_based")
    out = capsys.readouterr().out
    _val_loss(out)
    assert checkpoint.find_best_checkpoint(str(tmp_path / "ck" / "kd_logit_based_phase1"))


@pytest.mark.parametrize("extra,ckpt", [
    ((), "kd_double_trouble_phase1"),  # the CLI's default: double_trouble phase 1
    (("--kd_mode", "feature_based"), "kd_feature_based_phase1"),
], ids=["phase1", "feature_based"])
def test_kl_modes_run(tmp_path, capsys, extra, ckpt):
    _run(tmp_path, *extra)
    out = capsys.readouterr().out
    _val_loss(out)
    assert "training complete" in out
    assert checkpoint.find_best_checkpoint(str(tmp_path / "ck" / ckpt))


def _params(path):
    return checkpoint.CheckpointManager(os.path.dirname(path)).restore(path)["params"]


def _moved_roots(a, b):
    """The top-level modules (vision_tower, language_model, ...) with a
    parameter that differs between the state dicts a and b."""
    assert set(a) == set(b)
    return {k.split(".", 1)[0] for k in a if not torch.equal(a[k], b[k])}


def test_three_phase_chain(tmp_path, capsys):
    """Phases 1 -> 2 -> 3 through the CLI (the port's counterpart of the JAX
    ``tests/test_phase_chain.py``): each later phase starts from the
    previous phase's best checkpoint; phase 1 moves only the vision side
    (tower, projector, image newline) of the init, phase 2 only the
    language side (projector included) of phase 1's result."""
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli import (
        common,
    )

    best = {}
    for phase in (1, 2, 3):
        _run(tmp_path, "--phase", str(phase))
        out = capsys.readouterr().out
        _val_loss(out)
        if phase > 1:
            assert f"phase hand-off: initialized from {best[phase - 1]}" in out, out[-2000:]
        else:
            assert "phase hand-off" not in out
        best[phase] = checkpoint.find_best_checkpoint(str(tmp_path / "ck" / f"kd_double_trouble_phase{phase}"))
        assert best[phase] is not None

    args = train_online_kd.build_parser().parse_args(["--synthetic_data", "--cpu"])
    scfg, _ = common.model_configs(args)
    init = common.init_or_load_params(scfg, None, args.seed, attn_impl="xla",
                                      device=torch.device("cpu"), dtype=torch.float32).state_dict()
    p1, p2, p3 = (_params(best[k]) for k in (1, 2, 3))
    assert _moved_roots(init, p1) == {"vision_tower", "multi_modal_projector", "image_newline"}
    assert _moved_roots(p1, p2) == {"language_model", "multi_modal_projector", "image_newline"}
    assert {"vision_tower", "language_model"} <= _moved_roots(p2, p3)


@pytest.mark.parametrize("teacher_quant", ["int8", "int8_full"])
def test_int8_teacher_trains(tmp_path, capsys, monkeypatch, teacher_quant):
    """The teacher is built in float, then quantized once in place: its LM
    projections, and with int8_full its SigLIP projections too."""
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops import int8

    calls = []
    quantize = int8.quantize_model_int8

    def spy(model, include_vision=False, include_embed_head=False):
        calls.append((include_vision, include_embed_head))
        return quantize(model, include_vision, include_embed_head)

    monkeypatch.setattr(int8, "quantize_model_int8", spy)
    _run(tmp_path, "--phase", "2", "--teacher_quant", teacher_quant)
    out = capsys.readouterr().out
    _val_loss(out)
    assert "training complete" in out
    assert calls == [(teacher_quant == "int8_full", False)]
    assert checkpoint.find_best_checkpoint(str(tmp_path / "ck" / "kd_double_trouble_phase2"))


def test_faithful_loca_phase2_then_phase3(tmp_path, capsys, monkeypatch):
    """``--loca_faithful_indexing``: the LoCa term of both phases comes from
    ``chunked_faithful_loca`` (the reference's full-tensor column writes),
    and phase 3 starts from phase 2's best checkpoint."""
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.train import step

    calls = []
    faithful = step.chunked_faithful_loca

    def spy(*a, **kw):
        calls.append(kw["chunk_size"])
        return faithful(*a, **kw)

    monkeypatch.setattr(step, "chunked_faithful_loca", spy)
    _run(tmp_path, "--phase", "2", "--loca_faithful_indexing")
    out = capsys.readouterr().out
    _val_loss(out)
    n2 = len(calls)
    assert n2 > 0 and set(calls) == {32}  # the tiny configs' loss chunk
    best2 = checkpoint.find_best_checkpoint(str(tmp_path / "ck" / "kd_double_trouble_phase2"))
    assert best2 is not None

    _run(tmp_path, "--phase", "3", "--loca_faithful_indexing")
    out = capsys.readouterr().out
    assert f"phase hand-off: initialized from {best2}" in out
    _val_loss(out)
    assert len(calls) > n2
    assert checkpoint.find_best_checkpoint(str(tmp_path / "ck" / "kd_double_trouble_phase3"))


def test_daquar_trains(tmp_path, capsys):
    """``--dataset daquar --synthetic_data``: the synthetic DAQUAR tree
    (CSVs at the root, images/ and depth/), read by the port's DAQUAR
    reader."""
    _run(tmp_path, "--phase", "2", "--dataset", "daquar")
    out = capsys.readouterr().out
    _val_loss(out)
    assert "training complete" in out
    assert (tmp_path / "data" / "train_dataset.csv").exists()
    assert (tmp_path / "data" / "depth" / "image0_depth.png").exists()
    assert checkpoint.find_best_checkpoint(str(tmp_path / "ck" / "kd_double_trouble_phase2"))
