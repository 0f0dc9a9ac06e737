"""The port's KD kernels on the card against their plain PyTorch versions:
the combined LoCa + CE forward and backward (K11, ``csrc/fused_loca_ce.cu``)
at a ragged row count and a ragged vocab, on peaked teacher logits with
duplicated maxima and ignored labels; the autograd route of
``fused_loca_ce_loss`` against dense float32 LoCa + CE; the temperature KL
forward and backward (K7/K8, ``csrc/fused_kl.cu``) at a small ragged shape
with 1, 3 and 7 vocab splits and at the KD path's shape, its negative
controls, the dW skip under a frozen head, and its autograd route against
dense ``kd_kl_loss``; the teacher's float32 logits from bf16 operands; and
the flash forward at the 7B teacher's head dim (K3, D = 128).  Needs a CUDA
device; skips without one.

Run on the card (the tests' conftest imports jax, which the card's machine
may lack):
    python -m pytest --noconftest -m cuda tests/test_torch_kd_cuda.py

Tolerances, as in ``chip_smoke.py``: every output is held by its relative
Frobenius error ||got - plain|| / ||plain|| <= 1e-2 and by its max abs
error <= 1e-2 x max(1, max |plain|).  The forward is f32 on both sides
(the bf16 x bf16 products are exact in f32; only the summation order
differs).  The backward rounds ds to bf16 on both sides before the two
products and returns bf16 dh and dW (~2e-3 relative).  The tests show that
these bounds fail a K11 backward fed tsum = 0 and one fed g_kl = 0, and a
K8 fed a mis-normalised teacher (lse_t + 1) and one fed g = 0 for half the
rows."""

import pytest
import torch

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.configs import (
    llava_onevision_tiny_teacher,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.losses import (
    kd_kl_loss,
    loca_loss,
    masked_cross_entropy,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops import (
    _build,
    flash_attention as fa,
    fused_kl as fkl,
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
    LoCa labels ignored in rows 8-19 and at the tied maximum in row 0; CE
    labels ignored in the last 15 rows."""
    g = torch.Generator(device=dev).manual_seed(seed)
    hs = torch.randn(n, D, generator=g, device=dev).to(torch.bfloat16)
    ws = (torch.randn(v, D, generator=g, device=dev) * 0.05).to(torch.bfloat16)
    tmat = torch.randn(n, v, generator=g, device=dev) * 3.0
    top = tmat.max(dim=1).values + 2.0
    tmat[0:4, 5] = tmat[0:4, 7] = top[0:4]
    tmat[4:6, 3] = tmat[4:6, v - 2] = top[4:6]
    lab = torch.randint(0, v, (n,), generator=g, device=dev, dtype=torch.int32)
    lab_ce = torch.randint(0, v, (n,), generator=g, device=dev, dtype=torch.int32)
    lab[8:20] = -1
    lab[0] = 5
    lab_ce[-15:] = -1
    return hs, ws, tmat, lab, lab_ce


def _close(got, want):
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    fro = ((got - want).norm() / want.norm()).item()
    return err <= TOL * max(1.0, want.abs().max().item()) and fro <= FRO_TOL, (err, fro)


@pytest.mark.parametrize("n,v,temp", [(200, 1000, 0.8), (130, 2048, 1.0)])
def test_loca_ce_forward_matches_plain(dev, n, v, temp):
    hs, ws, tmat, lab, lab_ce = _inputs(dev, n, v)
    kw = dict(inv_t=1.0 / temp, alpha=0.8, eps=1e-8)
    fl.reset_launch_counts()
    got = fl.loca_ce_fwd(hs, ws, tmat, lab, lab_ce, **kw)
    torch.cuda.synchronize()
    assert fl.loca_ce_fwd.launches == 1
    want = fl.loca_ce_rows_ref(hs, ws, tmat, lab, lab_ce, **kw)
    for name, a, b in zip(("kl", "ce"), got[:2], want[:2]):
        ok, errs = _close(a, b)
        assert ok, (name, errs)
    for name, a, b in zip(fl.ROW_STATS, got[2], want[2]):
        ok, errs = _close(a, b)
        assert ok, (name, errs)


@pytest.mark.parametrize("g_ce_scale", [1.0, 0.0])
def test_loca_ce_backward_matches_plain(dev, g_ce_scale):
    n, v = 200, 1000
    hs, ws, tmat, lab, lab_ce = _inputs(dev, n, v, seed=1)
    kw = dict(inv_t=1.25, eps=1e-8)
    _, _, stats = fl.loca_ce_rows_ref(hs, ws, tmat, lab, lab_ce, alpha=0.8, **kw)
    g_kl = torch.ones(n, device=dev)
    g_ce = torch.full((n,), g_ce_scale, device=dev)
    fl.reset_launch_counts()
    dh, dw = fl.loca_ce_bwd(hs, ws, tmat, lab, lab_ce, stats, g_kl, g_ce, **kw)
    torch.cuda.synchronize()
    assert fl.loca_ce_bwd.launches == 1
    want_dh, want_dw = fl.loca_ce_rows_bwd_ref(hs, ws, tmat, lab, lab_ce, stats, g_kl, g_ce, **kw)
    assert dh.dtype == dw.dtype == torch.bfloat16
    for name, a, b in (("dh", dh, want_dh), ("dW", dw, want_dw)):
        ok, errs = _close(a, b)
        assert ok, (name, errs)


def test_loca_ce_backward_bounds_see_faults(dev):
    """A backward that loses tsum (the p_sT * tsum term) or g_kl (the whole
    KL term) fails the bounds the kernels are held by."""
    n, v = 200, 1000
    hs, ws, tmat, lab, lab_ce = _inputs(dev, n, v, seed=2)
    kw = dict(inv_t=1.25, eps=1e-8)
    _, _, stats = fl.loca_ce_rows_ref(hs, ws, tmat, lab, lab_ce, alpha=0.8, **kw)
    ones, zeros = torch.ones(n, device=dev), torch.zeros(n, device=dev)
    want = fl.loca_ce_rows_bwd_ref(hs, ws, tmat, lab, lab_ce, stats, ones, zeros, **kw)
    no_tsum = stats.clone()
    no_tsum[fl.ROW_STATS.index("tsum")] = 0.0
    got = fl.loca_ce_bwd(hs, ws, tmat, lab, lab_ce, no_tsum, ones, zeros, **kw)
    assert not all(_close(a, b)[0] for a, b in zip(got, want))
    want = fl.loca_ce_rows_bwd_ref(hs, ws, tmat, lab, lab_ce, stats, ones, ones, **kw)
    got = fl.loca_ce_bwd(hs, ws, tmat, lab, lab_ce, stats, zeros, ones, **kw)
    assert not all(_close(a, b)[0] for a, b in zip(got, want))


def test_fused_loca_ce_loss_autograd_matches_dense(dev):
    """Values and gradients of the kernel route against LoCa + masked CE on
    dense float32 logits (the loss functions the JAX package's fused path
    is parity-tested against)."""
    n, v, temp = 200, 1000, 0.8
    hs, ws, tmat, lab, lab_ce = _inputs(dev, n, v, seed=3)
    lab_ce[lab_ce < 0] = -100
    hs.requires_grad_(True)
    ws.requires_grad_(True)
    fl.reset_launch_counts()
    loca, ce = fl.fused_loca_ce_loss(hs, ws, tmat, lab, lab_ce, temperature=temp, alpha=0.8)
    gh, gw = torch.autograd.grad(0.8 * loca + ce, (hs, ws))
    assert fl.loca_ce_fwd.launches == 1 and fl.loca_ce_bwd.launches == 1

    hf, wf = hs.detach().float().requires_grad_(True), ws.detach().float().requires_grad_(True)
    logits = (hf @ wf.T)[None]
    want_loca = loca_loss(tmat[None] * temp, logits, lab[None].long(), temperature=temp, alpha=0.8)
    # masked_cross_entropy shifts by one: feed the CE labels one step later
    shifted = torch.cat([torch.full_like(lab_ce[:1], -100), lab_ce])[None].long()
    want_ce = masked_cross_entropy(torch.cat([logits, logits[:, :1]], dim=1), shifted)
    rh, rw = torch.autograd.grad(0.8 * want_loca + want_ce, (hf, wf))
    assert abs(loca.item() - want_loca.item()) <= 1e-4 * abs(want_loca.item())
    assert abs(ce.item() - want_ce.item()) <= 1e-4 * abs(want_ce.item())
    for name, a, b in (("dh", gh, rh), ("dW", gw, rw)):
        ok, errs = _close(a, b)
        assert ok, (name, errs)


def _kl_inputs(dev, n, v, seed=0):
    """hs, ws bf16 and peaked f32 teacher logits (std 3) at 1/T."""
    g = torch.Generator(device=dev).manual_seed(seed)
    hs = torch.randn(n, D, generator=g, device=dev).to(torch.bfloat16)
    ws = (torch.randn(v, D, generator=g, device=dev) * 0.05).to(torch.bfloat16)
    return hs, ws, torch.randn(n, v, generator=g, device=dev) * 3.0


@pytest.mark.parametrize("nsplit", [1, 3, 7])
def test_kl_forward_matches_plain_at_any_split(dev, nsplit):
    """K7's sweep and combine at a ragged row count and vocab, the vocab cut
    into 1, 3 or 7 splits of the sweep (the cross-split rescale of Zt, U and
    W), each writing a partial per consumer warpgroup."""
    n, v, inv_t = 200, 1000, 1.25
    hs, ws, tmat = _kl_inputs(dev, n, v)
    part = torch.empty(6, 2 * nsplit, n, device=dev)
    got = [torch.empty(n, device=dev) for _ in range(3)]
    _build.kl_fwd(hs, ws, tmat, part, *got, inv_t)
    torch.cuda.synchronize()
    want = fkl.kl_rows_ref(hs, ws, tmat, inv_t=inv_t)
    for name, a, b in zip(("kl", "lse_s", "lse_t"), got, want):
        ok, errs = _close(a, b)
        assert ok, (name, errs)


@pytest.mark.parametrize("nsplit", [1, 3, 7])
def test_kl_backward_matches_plain_at_any_split(dev, nsplit):
    """K8's ds sweep cut into 1, 3 or 7 vocab splits, and dh's product into
    as many splits of its f32 partials."""
    n, v, inv_t = 200, 1000, 1.25
    hs, ws, tmat = _kl_inputs(dev, n, v, seed=1)
    _, lse_s, lse_t = fkl.kl_rows_ref(hs, ws, tmat, inv_t=inv_t)
    g = torch.rand(n, device=dev) + 0.5
    dh, dw = torch.empty_like(hs), torch.empty_like(ws)
    ds = torch.empty(n, v, dtype=torch.bfloat16, device=dev)
    _build.kl_bwd(hs, ws, tmat, lse_s, lse_t, g, ds, torch.empty(nsplit, n, D, device=dev), dh, dw, nsplit, inv_t)
    torch.cuda.synchronize()
    want_dh, want_dw = fkl.kl_rows_bwd_ref(hs, ws, tmat, lse_s, lse_t, g, inv_t=inv_t)
    for name, a, b in (("dh", dh, want_dh), ("dW", dw, want_dw)):
        ok, errs = _close(a, b)
        assert ok, (name, errs)


def test_kl_kernels_at_the_path_shape(dev):
    """K7 and K8 through their wrappers at N = 3072 rows and the 151936-row
    student head, with the dW skip: the same dh, no dW, one dh launch
    more and no dW launch more."""
    n, v, inv_t = 3072, 151936, 1.25
    hs, ws, tmat = _kl_inputs(dev, n, v, seed=2)
    fkl.reset_launch_counts()
    got = fkl.kl_fwd(hs, ws, tmat, inv_t=inv_t)
    want = fkl.kl_rows_ref(hs, ws, tmat, inv_t=inv_t)
    for name, a, b in zip(("kl", "lse_s", "lse_t"), got, want):
        ok, errs = _close(a, b)
        assert ok, (name, errs)
    g = torch.ones(n, device=dev)
    dh, dw = fkl.kl_bwd(hs, ws, tmat, want[1], want[2], g, inv_t=inv_t)
    dh2, dw2 = fkl.kl_bwd(hs, ws, tmat, want[1], want[2], g, inv_t=inv_t, need_dw=False)
    torch.cuda.synchronize()
    assert dw2 is None and torch.equal(dh, dh2)
    assert (fkl.kl_fwd.launches, fkl.kl_bwd.launches, fkl.kl_bwd.dw_launches) == (1, 2, 1)
    want_dh, want_dw = fkl.kl_rows_bwd_ref(hs, ws, tmat, want[1], want[2], g, inv_t=inv_t)
    for name, a, b in (("dh", dh, want_dh), ("dW", dw, want_dw)):
        ok, errs = _close(a, b)
        assert ok, (name, errs)


def test_kl_backward_bounds_see_faults(dev):
    """A K8 fed a mis-normalised teacher (lse_t + 1) or a cotangent of 0 in
    half the rows fails the bounds the kernels are held by."""
    n, v, inv_t = 200, 1000, 1.25
    hs, ws, tmat = _kl_inputs(dev, n, v, seed=3)
    _, lse_s, lse_t = fkl.kl_rows_ref(hs, ws, tmat, inv_t=inv_t)
    g = torch.ones(n, device=dev)
    want = fkl.kl_rows_bwd_ref(hs, ws, tmat, lse_s, lse_t, g, inv_t=inv_t)
    got = fkl.kl_bwd(hs, ws, tmat, lse_s, lse_t + 1.0, g, inv_t=inv_t)
    assert not all(_close(a, b)[0] for a, b in zip(got, want))
    half = g.clone()
    half[::2] = 0.0
    got = fkl.kl_bwd(hs, ws, tmat, lse_s, lse_t, half, inv_t=inv_t)
    assert not all(_close(a, b)[0] for a, b in zip(got, want))


@pytest.mark.parametrize("head_grad", [True, False], ids=["trained_head", "frozen_head"])
def test_fused_kl_loss_autograd_matches_dense(dev, head_grad):
    """Values and gradients of the kernel route against ``kd_kl_loss`` on
    dense float32 logits; a frozen head launches no dW kernel."""
    n, v, temp = 200, 1000, 0.8
    hs, ws, tmat = _kl_inputs(dev, n, v, seed=4)
    hs.requires_grad_(True)
    ws.requires_grad_(head_grad)
    fkl.reset_launch_counts()
    loss = fkl.fused_kl_loss(hs, ws, tmat, temperature=temp)
    leaves = (hs, ws) if head_grad else (hs,)
    grads = torch.autograd.grad(loss, leaves)
    assert (fkl.kl_fwd.launches, fkl.kl_bwd.launches, fkl.kl_bwd.dw_launches) == (1, 1, int(head_grad))

    hf, wf = hs.detach().float().requires_grad_(True), ws.detach().float().requires_grad_(True)
    want = kd_kl_loss((hf @ wf.T)[None], tmat[None] * temp, temp)
    ref = torch.autograd.grad(want, (hf, wf)[:len(leaves)])
    assert abs(loss.item() - want.item()) <= 1e-4 * abs(want.item())
    for name, a, b in zip(("dh", "dW"), grads, ref):
        ok, errs = _close(a, b)
        assert ok, (name, errs)


def test_teacher_logits_are_float32_from_bf16_operands(dev):
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli import (
        common,
    )
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.train import (
        step,
    )
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.utils.synthetic import (
        synthetic_kd_batch,
    )

    cfg = llava_onevision_tiny_teacher()
    teacher = common.init_or_load_params(cfg, None, 1, attn_impl="xla", device=dev,
                                         dtype=torch.bfloat16)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in synthetic_kd_batch(cfg, 2, 96, seed=3).items()}
    got, t_vis = step._teacher_logits(teacher, batch, vocab=512, temperature=0.8)
    assert got.dtype == torch.float32 and got.shape == (2 * 96, 512)
    assert t_vis.shape == (2, batch["tile_valid"].shape[1], cfg.vision.hidden_size)
    with torch.no_grad():
        _, _, _, hidden = teacher(
            input_ids=batch["teacher_input_ids"], attention_mask=batch["teacher_attention_mask"],
            pixel_values=batch["teacher_pixel_values"], pack_idx=batch["pack_idx"],
            pack_weight=batch["pack_weight"], pack_valid=batch["pack_valid"],
            tile_valid=batch["tile_valid"], return_hidden=True, compute_logits=False)
        want = hidden.reshape(-1, hidden.shape[-1]).float() @ teacher.language_model.lm_head.weight[:512].float().T / 0.8
    # both accumulate exact bf16 products in f32: only the order differs
    assert (got - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item())


def test_flash_forward_teacher_head_dim(dev):
    """K3 at D = 128 (the 7B teacher's 28 q / 4 kv heads), causal with a kv
    mask and a ragged last tile; forward only, no lse."""
    g = torch.Generator(device=dev).manual_seed(4)
    mk = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)  # noqa: E731
    q, k, v = mk(1, 300, 28, 128), mk(1, 300, 4, 128), mk(1, 300, 4, 128)
    mask = torch.zeros(1, 300, dtype=torch.bool, device=dev)
    mask[:, :250] = True
    fa.reset_launch_counts()
    got = fa.flash_attention(q, k, v, mask=mask, causal=True)
    torch.cuda.synchronize()
    assert fa.flash_attention_gqa.head_dim_launches == {128: 1}
    want = fa.flash_attention_ref(q, k, v, mask, True)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    # D = 128 has no backward kernel: asking for one is refused up front
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q.requires_grad_(True), k, v, mask=mask, causal=True)
