"""LoCa without CE on the card (K9, ``csrc/fused_loca_ce.cu`` with its CE
flag off) against its plain PyTorch versions, and the tiny CLIs on the card.

* K9's forward and backward (with and without dW) at ragged row counts and
  vocabularies, on peaked teacher logits with duplicated maxima and ignored
  labels, against ``loca_rows_ref`` / ``loca_rows_bwd_ref``;
* its bounds fail a backward fed tsum = 0 and one fed g = 0 in half the rows;
* K9 equals K11's LoCa part on the same inputs: its KL rows and row
  statistics (lse_s1 aside), and its dh / dW against K11's backward with
  g_ce = 0;
* the autograd route of ``fused_loca_loss`` against dense float32
  ``loca_loss``;
* K11 and K9 on the wgmma/TMA core (``csrc/kdss_vocab_sm90.cuh``) at the
  student's vocabulary V = 151936 (no multiple of 256) with N = 300 rows (no
  multiple of the core's 128-row block), teacher maxima tied inside a vocab
  tile, across two tiles, across vocab splits and at column V - 1, LoCa and
  CE labels at column V - 1; two launches of each bit-identical; and the
  refusal of a vocabulary that is not a multiple of 4;
* the tiny ``--synthetic_data`` baseline and KD CLIs (``--loca_faithful_indexing``
  too) train on the card: their width and head dims are not the kernels',
  so the CLIs choose the plain routes from the config.

Needs a CUDA device; skips without one.  Run on the card (the tests'
conftest imports jax, which the card's machine may lack):
    python -m pytest --noconftest -m cuda tests/test_torch_fused_loca_cuda.py

Tolerances, as in ``chip_smoke.py``: every output is held by its relative
Frobenius error <= 1e-2 and its max abs error <= 1e-2 x max(1, max |plain|);
the forward is f32 on both sides (only the summation order differs), the
backward rounds ds to bf16 on both sides and returns bf16 dh and dW."""

import math
import re

import pytest
import torch

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.losses import (
    loca_loss,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops import (
    fused_loca as fl,
)

pytestmark = pytest.mark.cuda
TOL = 1e-2
FRO_TOL = 1e-2
D = 896  # the 0.5B student's width, the one the kernels are compiled for


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built for sm_90a)")
    return torch.device("cuda", 0)


def _inputs(dev, n, v, seed=0):
    """hs, ws bf16; peaked f32 teacher logits (std 3) whose maximum is
    duplicated in rows 0-5 (inside one vocab tile, and across the vocab);
    labels ignored in rows 8-19 and at the tied maximum in row 0."""
    g = torch.Generator(device=dev).manual_seed(seed)
    hs = torch.randn(n, D, generator=g, device=dev).to(torch.bfloat16)
    ws = (torch.randn(v, D, generator=g, device=dev) * 0.05).to(torch.bfloat16)
    tmat = torch.randn(n, v, generator=g, device=dev) * 3.0
    top = tmat.max(dim=1).values + 2.0
    tmat[0:4, 5] = tmat[0:4, 7] = top[0:4]
    tmat[4:6, 3] = tmat[4:6, v - 2] = top[4:6]
    lab = torch.randint(0, v, (n,), generator=g, device=dev, dtype=torch.int32)
    lab[8:20] = -1
    lab[0] = 5
    return hs, ws, tmat, lab


def _close(got, want):
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    fro = ((got - want).norm() / want.norm()).item()
    return err <= TOL * max(1.0, want.abs().max().item()) and fro <= FRO_TOL, (err, fro)


@pytest.mark.parametrize("n,v,temp", [(200, 1000, 0.8), (130, 2048, 1.0)])
def test_loca_forward_matches_plain(dev, n, v, temp):
    hs, ws, tmat, lab = _inputs(dev, n, v)
    kw = dict(inv_t=1.0 / temp, alpha=0.8, eps=1e-8)
    fl.reset_launch_counts()
    kl, stats = fl.loca_fwd(hs, ws, tmat, lab, **kw)
    torch.cuda.synchronize()
    assert (fl.loca_fwd.launches, fl.loca_ce_fwd.launches) == (1, 0)
    want_kl, want_stats = fl.loca_rows_ref(hs, ws, tmat, lab, **kw)
    ok, errs = _close(kl, want_kl)
    assert ok, ("kl", errs)
    for name, a, b in zip(fl.ROW_STATS, stats, want_stats):
        if name == "lse_s1":  # K9 computes no CE: it leaves lse_s1 at 0
            assert not a.any() and not b.any()
            continue
        ok, errs = _close(a, b)
        assert ok, (name, errs)


@pytest.mark.parametrize("need_dw", [True, False], ids=["dw", "dh_only"])
def test_loca_backward_matches_plain(dev, need_dw):
    n, v = 200, 1000
    hs, ws, tmat, lab = _inputs(dev, n, v, seed=1)
    kw = dict(inv_t=1.25, eps=1e-8)
    _, stats = fl.loca_rows_ref(hs, ws, tmat, lab, alpha=0.8, **kw)
    g = torch.rand(n, device=dev) + 0.5
    fl.reset_launch_counts()
    dh, dw = fl.loca_bwd(hs, ws, tmat, lab, stats, g, need_dw=need_dw, **kw)
    torch.cuda.synchronize()
    assert (fl.loca_bwd.launches, fl.loca_ce_bwd.launches) == (1, 0)
    want_dh, want_dw = fl.loca_rows_bwd_ref(hs, ws, tmat, lab, stats, g, **kw)
    assert dh.dtype == torch.bfloat16 and (dw is not None) == need_dw
    for name, a, b in (("dh", dh, want_dh), ("dW", dw, want_dw))[:1 + need_dw]:
        ok, errs = _close(a, b)
        assert ok, (name, errs)


def test_loca_backward_bounds_see_faults(dev):
    """A backward that loses tsum (the p_sT * tsum term) or the cotangent of
    every other row fails the bounds the kernels are held by."""
    n, v = 200, 1000
    hs, ws, tmat, lab = _inputs(dev, n, v, seed=2)
    kw = dict(inv_t=1.25, eps=1e-8)
    _, stats = fl.loca_rows_ref(hs, ws, tmat, lab, alpha=0.8, **kw)
    g = torch.ones(n, device=dev)
    want = fl.loca_rows_bwd_ref(hs, ws, tmat, lab, stats, g, **kw)
    no_tsum = stats.clone()
    no_tsum[fl.ROW_STATS.index("tsum")] = 0.0
    got = fl.loca_bwd(hs, ws, tmat, lab, no_tsum, g, **kw)
    assert not all(_close(a, b)[0] for a, b in zip(got, want))
    half = g.clone()
    half[::2] = 0.0
    got = fl.loca_bwd(hs, ws, tmat, lab, stats, half, **kw)
    assert not all(_close(a, b)[0] for a, b in zip(got, want))


def test_k9_is_the_loca_part_of_k11(dev):
    """On the same inputs K9's KL rows and statistics are K11's, and K9's
    backward is K11's with g_ce = 0."""
    n, v = 200, 1000
    hs, ws, tmat, lab = _inputs(dev, n, v, seed=3)
    lab_ce = torch.randint(0, v, (n,), device=dev, dtype=torch.int32)
    fwd_kw = dict(inv_t=1.25, alpha=0.8, eps=1e-8)
    kl9, st9 = fl.loca_fwd(hs, ws, tmat, lab, **fwd_kw)
    kl11, _, st11 = fl.loca_ce_fwd(hs, ws, tmat, lab, lab_ce, **fwd_kw)
    keep = [i for i, name in enumerate(fl.ROW_STATS) if name != "lse_s1"]
    for a, b in ((kl9, kl11), (st9[keep], st11[keep])):
        ok, errs = _close(a, b)
        assert ok and errs[0] <= 1e-5 * max(1.0, b.abs().max().item()), errs
    g = torch.ones(n, device=dev)
    got = fl.loca_bwd(hs, ws, tmat, lab, st11, g, inv_t=1.25, eps=1e-8)
    want = fl.loca_ce_bwd(hs, ws, tmat, lab, lab_ce, st11, g, torch.zeros_like(g), inv_t=1.25, eps=1e-8)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_fused_loca_loss_autograd_matches_dense(dev):
    """Values and gradients of the kernel route against ``loca_loss`` on
    dense float32 logits."""
    n, v, temp = 200, 1000, 0.8
    hs, ws, tmat, lab = _inputs(dev, n, v, seed=4)
    hs.requires_grad_(True)
    ws.requires_grad_(True)
    fl.reset_launch_counts()
    loss = fl.fused_loca_loss(hs, ws, tmat, lab, temperature=temp, alpha=0.8)
    gh, gw = torch.autograd.grad(loss, (hs, ws))
    assert (fl.loca_fwd.launches, fl.loca_bwd.launches) == (1, 1)

    hf, wf = hs.detach().float().requires_grad_(True), ws.detach().float().requires_grad_(True)
    want = loca_loss(tmat[None] * temp, (hf @ wf.T)[None], lab[None].long(), temperature=temp, alpha=0.8)
    rh, rw = torch.autograd.grad(want, (hf, wf))
    assert abs(loss.item() - want.item()) <= 1e-4 * abs(want.item())
    for name, a, b in (("dh", gh, rh), ("dW", gw, rw)):
        ok, errs = _close(a, b)
        assert ok, (name, errs)


def _path_vocab_inputs(dev, n=300, v=151936, seed=5):
    """The student's vocabulary at a ragged row count: maxima tied inside one
    vocab tile (rows 0-3), across two 128-column tiles (4-7), across vocab
    splits (8-11) and at the last column (12-15); labels at the tied maxima
    and at column V - 1."""
    g = torch.Generator(device=dev).manual_seed(seed)
    hs = torch.randn(n, D, generator=g, device=dev).to(torch.bfloat16)
    ws = (torch.randn(v, D, generator=g, device=dev) * 0.05).to(torch.bfloat16)
    tmat = torch.randn(n, v, generator=g, device=dev) * 3.0
    top = tmat.max(dim=1).values + 2.0
    for rows, (a, b) in ((slice(0, 4), (5, 7)), (slice(4, 8), (120, 130)), (slice(8, 12), (11, v - 3)),
                         (slice(12, 16), (0, v - 1))):
        tmat[rows, a] = tmat[rows, b] = top[rows]
    lab = torch.randint(0, v, (n,), generator=g, device=dev, dtype=torch.int32)
    lab_ce = torch.randint(0, v, (n,), generator=g, device=dev, dtype=torch.int32)
    lab[0], lab[4], lab[8], lab[12], lab[20] = 5, 130, v - 3, v - 1, v - 1
    lab_ce[21] = v - 1
    lab[30:40] = -1
    lab_ce[-10:] = -1
    return hs, ws, tmat, lab, lab_ce


def test_k11_and_k9_at_the_path_vocabulary_ragged_and_tied(dev):
    hs, ws, tmat, lab, lab_ce = _path_vocab_inputs(dev)
    kw = dict(inv_t=1.25, eps=1e-8)
    kl, ce, stats = fl.loca_ce_fwd(hs, ws, tmat, lab, lab_ce, alpha=0.8, **kw)
    torch.cuda.synchronize()
    want = fl.loca_ce_rows_ref(hs, ws, tmat, lab, lab_ce, alpha=0.8, **kw)
    for name, a, b in [("kl", kl, want[0]), ("ce", ce, want[1])] + list(zip(fl.ROW_STATS, stats, want[2])):
        ok, errs = _close(a, b)
        assert ok, (name, errs)
    g = torch.rand(hs.shape[0], device=dev) + 0.5
    dh, dw = fl.loca_ce_bwd(hs, ws, tmat, lab, lab_ce, want[2], g, g, **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(("dh", "dW"), (dh, dw),
                          fl.loca_ce_rows_bwd_ref(hs, ws, tmat, lab, lab_ce, want[2], g, g, **kw)):
        ok, errs = _close(a, b)
        assert ok, (name, errs)
    kl9, st9 = fl.loca_fwd(hs, ws, tmat, lab, alpha=0.8, **kw)
    keep = [i for i, name in enumerate(fl.ROW_STATS) if name != "lse_s1"]
    assert torch.equal(kl9, kl) and torch.equal(st9[keep], stats[keep])
    dh9, dw9 = fl.loca_bwd(hs, ws, tmat, lab, want[2], g, **kw)
    dh11, dw11 = fl.loca_ce_bwd(hs, ws, tmat, lab, lab_ce, want[2], g, torch.zeros_like(g), **kw)
    assert torch.equal(dh9, dh11) and torch.equal(dw9, dw11)


def test_a_vocabulary_not_a_multiple_of_4_is_refused(dev):
    hs, ws, tmat, lab = _inputs(dev, 8, 1002)
    with pytest.raises(ValueError, match="multiple of 4"):
        fl.loca_fwd(hs, ws, tmat, lab, inv_t=1.25, alpha=0.8, eps=1e-8)
    with pytest.raises(ValueError, match="multiple of 4"):
        fl.loca_ce_fwd(hs, ws, tmat, lab, lab, inv_t=1.25, alpha=0.8, eps=1e-8)


def test_two_launches_are_bit_identical(dev):
    n, v = 200, 1000
    hs, ws, tmat, lab = _inputs(dev, n, v, seed=6)
    lab_ce = torch.randint(0, v, (n,), device=dev, dtype=torch.int32)
    kw = dict(inv_t=1.25, eps=1e-8)
    _, _, stats = fl.loca_ce_rows_ref(hs, ws, tmat, lab, lab_ce, alpha=0.8, **kw)
    g = torch.rand(n, device=dev) + 0.5
    runs = (lambda: fl.loca_ce_fwd(hs, ws, tmat, lab, lab_ce, alpha=0.8, **kw),
            lambda: fl.loca_ce_bwd(hs, ws, tmat, lab, lab_ce, stats, g, g, **kw),
            lambda: fl.loca_fwd(hs, ws, tmat, lab, alpha=0.8, **kw),
            lambda: fl.loca_bwd(hs, ws, tmat, lab, stats, g, **kw))
    for run in runs:
        a, b = run(), run()
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def _val_loss(out):
    val = [float(x) for x in re.findall(r"val_loss (\S+)", out)]
    assert len(val) == 1 and math.isfinite(val[0]), out[-2000:]
    return val[0]


@pytest.mark.parametrize("cli,extra", [
    ("train", ()),
    ("train", ("--dataset", "daquar")),
    ("train_online_kd", ("--phase", "2")),
    ("train_online_kd", ("--phase", "2", "--loca_faithful_indexing")),
], ids=["baseline", "baseline_daquar", "kd_phase2", "kd_phase2_faithful"])
def test_tiny_cli_trains_on_the_card(dev, tmp_path, capsys, cli, extra):
    """No ``--real_model`` and no ``--cpu``: the tiny configs train on CUDA
    through the plain routes, chosen from their widths and head dims."""
    import importlib

    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops import (
        fused_ce as fc,
        flash_attention as fa,
    )

    mod = importlib.import_module(
        f"knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli.{cli}")
    fa.reset_launch_counts()
    fc.reset_launch_counts()
    fl.reset_launch_counts()
    mod.main(["--synthetic_data", "--accumulate_grad_batches", "1", "--num_workers", "1",
              "--root_data_dir", str(tmp_path / "data"), "--checkpoint_dir", str(tmp_path / "ck"),
              "--tensorboard_dir", str(tmp_path / "tb"), *extra])
    out = capsys.readouterr().out
    _val_loss(out)
    assert "training complete" in out
    assert fa.flash_attention.launches == 0 and fc.lse_gold_fwd.launches == 0
    assert fl.loca_ce_fwd.launches == 0 and fl.loca_fwd.launches == 0
