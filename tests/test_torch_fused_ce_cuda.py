"""The fused CE on the card (``csrc/fused_ce.cu`` on the Hopper vocab core
``csrc/kdss_vocab_sm90.cuh``) against its plain PyTorch versions: the
forward K5 (one sweep that keeps each row's online logsumexp and gold
logit, then a combine of its partials) against ``lse_gold_ref``, and the
backward K6 (one sweep that writes the bf16 d_logits ds, then dh = ds w and
dW = ds^T h) against ``lse_gold_bwd_ref``.

* K5 at N = 3072, 300 and 130 rows over V = 151936, 2052, 1004 and 1001
  (more than one vocab split at each), a label at column V - 1, lse and
  gold within 2e-3 (both sides sum exact bf16 products in f32); labels
  shifted by one column failing that bound; two launches bit-identical;
* K6 at the training path's shape (N = 3072 rows over the 151936 x 896 tied
  head) and at ragged ones: N a multiple of neither the sweep's 64-row block
  nor the products' 128-row tile, V a multiple of neither the 128-column
  vocab tile nor 4 (K6 reads no teacher, so it takes any V), a label at
  column V - 1, ignored rows with zero cotangents;
* g_gold = 0 (the softmax term alone) and a backward fed g_lse = 0 failing
  the bounds;
* two launches bit-identical;
* ``fused_ce_loss``'s autograd route against dense float32 cross-entropy;
* the wrapper refusing what the kernels cannot take.

Needs a CUDA device; skips without one.  Run on the card (the tests'
conftest imports jax, which the card's machine may lack):
    python -m pytest --noconftest -m cuda tests/test_torch_fused_ce_cuda.py

Tolerances, as in ``chip_smoke.py``: dh by its max abs error <= 2e-2 x
max(1, max |plain|), dW by <= 2e-2 of its max norm (its entries sum over
all N rows), both by their relative Frobenius error <= 1e-2.  Both sides
round ds to bf16 before the two products and return bf16; only the
summation order differs."""

import pytest
import torch

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops import (
    fused_ce as fc,
    vocab_core as vc,
)

pytestmark = pytest.mark.cuda
TOL = 2e-2
FRO_TOL = 1e-2
ROW_TOL = 2e-3  # K5's lse and gold, as in test_torch_train_cuda.py
D = 896  # the 0.5B student's width, the one the kernels are compiled for


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built for sm_90a)")
    return torch.device("cuda", 0)


def _inputs(dev, n, v, seed=0):
    """h, w bf16; labels with one at column V - 1; the plain lse; cotangents
    of the summed NLL (g_lse = 1, g_gold = -1) with the first three rows
    ignored (zero cotangents)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn(n, D, generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn(v, D, generator=g, device=dev) * 0.02).to(torch.bfloat16)
    labels = torch.randint(0, v, (n,), generator=g, device=dev, dtype=torch.int32)
    labels[5] = v - 1
    lse, _ = fc.lse_gold_ref(h, w, labels)
    g_lse = torch.ones(n, device=dev)
    g_lse[:3] = 0.0
    return h, w, labels, lse, g_lse, -g_lse


def _fro(a, want):
    return ((a.float() - want.float()).norm() / want.float().norm()).item()


def _close(dh, dw, want_dh, want_dw):
    err_h = (dh.float() - want_dh.float()).abs().max().item()
    err_w = (dw.float() - want_dw.float()).abs().max().item()
    ok = (err_h <= TOL * max(1.0, want_dh.float().abs().max().item())
          and err_w <= TOL * want_dw.float().abs().max().item()
          and _fro(dh, want_dh) <= FRO_TOL and _fro(dw, want_dw) <= FRO_TOL)
    return ok, (err_h, err_w, _fro(dh, want_dh), _fro(dw, want_dw))


def _fwd_inputs(dev, n, v, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn(n, D, generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn(v, D, generator=g, device=dev) * 0.02).to(torch.bfloat16)
    labels = torch.randint(0, v, (n,), generator=g, device=dev, dtype=torch.int32)
    labels[5] = v - 1
    return h, w, labels


def _err(a, want):
    return (a.float() - want.float()).abs().max().item()


@pytest.mark.parametrize("v", [151936, 2052, 1004, 1001])
@pytest.mark.parametrize("n", [3072, 300, 130])
def test_ce_forward_matches_plain(dev, n, v):
    h, w, labels = _fwd_inputs(dev, n, v)
    assert vc.plan_for(h, w)["nsplit"] > 1
    fc.reset_launch_counts()
    lse, gold = fc.lse_gold_fwd(h, w, labels)
    torch.cuda.synchronize()
    assert fc.lse_gold_fwd.launches == 1
    want_lse, want_gold = fc.lse_gold_ref(h, w, labels)
    assert _err(lse, want_lse) <= ROW_TOL and _err(gold, want_gold) <= ROW_TOL, (
        _err(lse, want_lse), _err(gold, want_gold))


def test_ce_forward_bound_sees_a_shifted_label(dev):
    h, w, labels = _fwd_inputs(dev, 300, 1001, seed=5)
    _, want_gold = fc.lse_gold_ref(h, w, labels)
    _, gold = fc.lse_gold_fwd(h, w, (labels + 1) % w.shape[0])
    assert _err(gold, want_gold) > ROW_TOL


@pytest.mark.parametrize("n,v", [(3072, 151936), (130, 1001)])
def test_ce_forward_two_launches_are_bit_identical(dev, n, v):
    h, w, labels = _fwd_inputs(dev, n, v, seed=6)
    a, b = fc.lse_gold_fwd(h, w, labels), fc.lse_gold_fwd(h, w, labels)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("n,v", [(3072, 151936), (300, 1001), (130, 2050), (3000, 151936)],
                         ids=["path", "ragged_odd_v", "ragged_v", "ragged_n"])
@pytest.mark.parametrize("gold", ["g_gold=-1", "g_gold=0"])
def test_ce_backward_matches_plain(dev, n, v, gold):
    h, w, labels, lse, g_lse, g_gold = _inputs(dev, n, v)
    if gold == "g_gold=0":  # the softmax term alone
        g_gold = torch.zeros_like(g_gold)
    fc.reset_launch_counts()
    dh, dw = fc.lse_gold_bwd(h, w, labels, lse, g_lse, g_gold)
    torch.cuda.synchronize()
    assert fc.lse_gold_bwd.launches == 1
    assert dh.dtype == dw.dtype == torch.bfloat16 and dh.shape == h.shape and dw.shape == w.shape
    ok, errs = _close(dh, dw, *fc.lse_gold_bwd_ref(h, w, labels, lse, g_lse, g_gold))
    assert ok, errs
    assert (dh[:3] == 0).all()  # ignored rows


def test_ce_backward_bounds_see_a_missing_softmax_term(dev):
    h, w, labels, lse, g_lse, _ = _inputs(dev, 300, 1001, seed=1)
    g_gold = torch.zeros_like(g_lse)
    want = fc.lse_gold_bwd_ref(h, w, labels, lse, g_lse, g_gold)
    bad = fc.lse_gold_bwd(h, w, labels, lse, torch.zeros_like(g_lse), g_gold)
    assert not _close(*bad, *want)[0]


def test_ce_backward_two_launches_are_bit_identical(dev):
    h, w, labels, lse, g_lse, g_gold = _inputs(dev, 3000, 151936, seed=2)
    a = fc.lse_gold_bwd(h, w, labels, lse, g_lse, g_gold)
    b = fc.lse_gold_bwd(h, w, labels, lse, g_lse, g_gold)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("layout", ["vd", "dv"])
def test_fused_ce_loss_autograd_matches_dense(dev, layout):
    """Values and gradients of the kernel route (K5 forward, K6 backward)
    against dense float32 ``cross_entropy``, ignored labels included."""
    n, v = 300, 1001
    g = torch.Generator(device=dev).manual_seed(3)
    h = torch.randn(n, D, generator=g, device=dev).to(torch.bfloat16).requires_grad_()
    w_vd = (torch.randn(v, D, generator=g, device=dev) * 0.02).to(torch.bfloat16)
    w = (w_vd if layout == "vd" else w_vd.T).clone().requires_grad_()
    labels = torch.randint(0, v, (n,), generator=g, device=dev)
    labels[:7] = fc.IGNORE
    fc.reset_launch_counts()
    loss = fc.fused_ce_loss(h, w, labels, w_layout=layout)
    loss.backward()
    assert (fc.lse_gold_fwd.launches, fc.lse_gold_bwd.launches) == (1, 1)
    h32, w32 = h.detach().float().requires_grad_(), w_vd.float().requires_grad_()
    want = torch.nn.functional.cross_entropy(h32 @ w32.T, labels, ignore_index=fc.IGNORE)
    want.backward()
    assert abs(loss.item() - want.item()) <= 2e-3 * max(1.0, abs(want.item()))
    w_grad_vd = w.grad if layout == "vd" else w.grad.T
    assert _fro(h.grad, h32.grad) <= FRO_TOL and _fro(w_grad_vd, w32.grad) <= FRO_TOL
    assert (h.grad[:7] == 0).all()


def test_ce_backward_refuses_what_it_does_not_take(dev):
    h, w, labels, lse, g_lse, g_gold = _inputs(dev, 64, 1000, seed=4)
    with pytest.raises(ValueError, match="model dim"):
        fc.lse_gold_bwd(h[:, :128].contiguous(), w[:, :128].contiguous(), labels, lse, g_lse, g_gold)
    with pytest.raises(ValueError, match="bfloat16"):
        fc.lse_gold_bwd(h.float(), w, labels, lse, g_lse, g_gold)
    with pytest.raises(ValueError, match=r"\[N\]"):
        fc.lse_gold_bwd(h, w, labels, lse[:10], g_lse, g_gold)
