"""The temperature KL on the card (``csrc/fused_kl.cu`` on the Hopper vocab
core ``csrc/kdss_vocab_sm90.cuh``) against its plain PyTorch versions: the
forward K7 (one sweep that reads the teacher tile and keeps each row's
student and teacher statistics, then a combine of its partials) against
``kl_rows_ref``, and the backward K8 (one sweep that reads the teacher tile
and writes the bf16 d_logits ds, then dh = ds w and, where the head trains,
dW = ds^T h) against ``kl_rows_bwd_ref``.

* K7 at N = 3072, 300 and 130 rows over V = 151936, 2052 and 1004 (more
  than one vocab split at each); a forward that drops the student's 1/T
  failing the bounds; two launches bit-identical;
* K8 at the phase-1 path's shape (N = 3072 rows over the 151936-row student
  head) and at ragged ones (N a multiple of neither the sweep's 64-row
  block nor the products' 128-row tile, V no multiple of the 128-column
  vocab tile), with and without dW: without it the same dh, no dW and no dW
  launch;
* a backward fed a mis-normalised teacher (lse_t + 1) and one fed g = 0 in
  half the rows failing the bounds;
* two launches bit-identical;
* ``fused_kl_loss``'s autograd route against dense ``kd_kl_loss``;
* the refusal of a vocabulary that is not a multiple of 4 (the teacher is
  read in 8-byte pairs).

Needs a CUDA device; skips without one.  Run on the card (the tests'
conftest imports jax, which the card's machine may lack):
    python -m pytest --noconftest -m cuda tests/test_torch_fused_kl_cuda.py

Tolerances, as in ``chip_smoke.py``: every output is held by its max abs
error <= 1e-2 x max(1, max |plain|) and its relative Frobenius error
<= 1e-2.  Both sides round ds to bf16 before the two products and return
bf16 dh and dW; only the summation order differs."""

import pytest
import torch

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.losses import (
    kd_kl_loss,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops import (
    fused_kl as fkl,
    vocab_core as vc,
)

pytestmark = pytest.mark.cuda
TOL = 1e-2
FRO_TOL = 1e-2
D = 896  # the 0.5B student's width, the one the kernels are compiled for
INV_T = 0.5  # double trouble's temperature, 2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built for sm_90a)")
    return torch.device("cuda", 0)


def _inputs(dev, n, v, seed=0):
    """hs, ws bf16, peaked f32 teacher logits at 1/T (std 3), the plain lse_s
    and lse_t, and cotangents in [0.5, 1.5)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    hs = torch.randn(n, D, generator=g, device=dev).to(torch.bfloat16)
    ws = (torch.randn(v, D, generator=g, device=dev) * 0.05).to(torch.bfloat16)
    tmat = torch.randn(n, v, generator=g, device=dev) * 3.0
    _, lse_s, lse_t = fkl.kl_rows_ref(hs, ws, tmat, inv_t=INV_T)
    return hs, ws, tmat, lse_s, lse_t, torch.rand(n, generator=g, device=dev) + 0.5


def _close(got, want):
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    fro = ((got - want).norm() / want.norm()).item()
    return err <= TOL * max(1.0, want.abs().max().item()) and fro <= FRO_TOL, (err, fro)


@pytest.mark.parametrize("v", [151936, 2052, 1004])
@pytest.mark.parametrize("n", [3072, 300, 130])
def test_kl_forward_matches_plain(dev, n, v):
    hs, ws, tmat, _, _, _ = _inputs(dev, n, v)
    assert vc.plan_for(hs, ws)["nsplit"] > 1
    fkl.reset_launch_counts()
    got = fkl.kl_fwd(hs, ws, tmat, inv_t=INV_T)
    torch.cuda.synchronize()
    assert fkl.kl_fwd.launches == 1
    for name, a, b in zip(("kl", "lse_s", "lse_t"), got, fkl.kl_rows_ref(hs, ws, tmat, inv_t=INV_T)):
        ok, errs = _close(a, b)
        assert ok, (name, errs)


def test_kl_forward_bounds_see_a_dropped_temperature(dev):
    hs, ws, tmat, _, _, _ = _inputs(dev, 300, 1004, seed=5)
    want = fkl.kl_rows_ref(hs, ws, tmat, inv_t=INV_T)
    got = fkl.kl_fwd(hs, ws, tmat, inv_t=1.0)
    assert not all(_close(a, b)[0] for a, b in zip(got, want))


@pytest.mark.parametrize("n,v", [(3072, 151936), (130, 1004)])
def test_kl_forward_two_launches_are_bit_identical(dev, n, v):
    hs, ws, tmat, _, _, _ = _inputs(dev, n, v, seed=6)
    a, b = fkl.kl_fwd(hs, ws, tmat, inv_t=INV_T), fkl.kl_fwd(hs, ws, tmat, inv_t=INV_T)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("n,v", [(3072, 151936), (300, 1004), (130, 2052), (3000, 151936)],
                         ids=["path", "ragged", "ragged_v", "ragged_n"])
def test_kl_backward_matches_plain_with_and_without_dw(dev, n, v):
    hs, ws, tmat, lse_s, lse_t, g = _inputs(dev, n, v)
    fkl.reset_launch_counts()
    dh, dw = fkl.kl_bwd(hs, ws, tmat, lse_s, lse_t, g, inv_t=INV_T)
    dh_only, no_dw = fkl.kl_bwd(hs, ws, tmat, lse_s, lse_t, g, inv_t=INV_T, need_dw=False)
    torch.cuda.synchronize()
    assert (fkl.kl_bwd.launches, fkl.kl_bwd.dw_launches) == (2, 1)
    assert no_dw is None and torch.equal(dh_only, dh)
    want_dh, want_dw = fkl.kl_rows_bwd_ref(hs, ws, tmat, lse_s, lse_t, g, inv_t=INV_T)
    for name, a, b in (("dh", dh, want_dh), ("dW", dw, want_dw)):
        ok, errs = _close(a, b)
        assert ok, (name, errs)


@pytest.mark.parametrize("fault", ["lse_t + 1", "g = 0 in half the rows"])
def test_kl_backward_bounds_see_faults(dev, fault):
    hs, ws, tmat, lse_s, lse_t, g = _inputs(dev, 300, 1004, seed=1)
    want = fkl.kl_rows_bwd_ref(hs, ws, tmat, lse_s, lse_t, g, inv_t=INV_T)
    if fault == "lse_t + 1":
        lse_t = lse_t + 1.0
    else:
        g = g.clone()
        g[::2] = 0.0
    got = fkl.kl_bwd(hs, ws, tmat, lse_s, lse_t, g, inv_t=INV_T)
    assert not all(_close(a, b)[0] for a, b in zip(got, want))


@pytest.mark.parametrize("need_dw", [True, False], ids=["dw", "dh_only"])
def test_kl_backward_two_launches_are_bit_identical(dev, need_dw):
    hs, ws, tmat, lse_s, lse_t, g = _inputs(dev, 3000, 151936, seed=2)
    a = fkl.kl_bwd(hs, ws, tmat, lse_s, lse_t, g, inv_t=INV_T, need_dw=need_dw)
    b = fkl.kl_bwd(hs, ws, tmat, lse_s, lse_t, g, inv_t=INV_T, need_dw=need_dw)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b) if x is not None)


@pytest.mark.parametrize("head_grad", [True, False], ids=["trained_head", "frozen_head"])
def test_fused_kl_loss_autograd_matches_dense(dev, head_grad):
    """Values and gradients of the kernel route (K7 forward, K8 backward) at
    a ragged shape against ``kd_kl_loss`` on dense float32 logits; a frozen
    head launches no dW product."""
    n, v, temp = 300, 1004, 2.0
    hs, ws, tmat, _, _, _ = _inputs(dev, n, v, seed=3)
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


def test_a_vocabulary_not_a_multiple_of_4_is_refused(dev):
    hs, ws, tmat, lse_s, lse_t, g = _inputs(dev, 64, 1002, seed=4)
    with pytest.raises(ValueError, match="multiple of 4"):
        fkl.kl_bwd(hs, ws, tmat, lse_s, lse_t, g, inv_t=INV_T)
    with pytest.raises(ValueError, match="multiple of 4"):
        fkl.kl_fwd(hs, ws, tmat, inv_t=INV_T)
