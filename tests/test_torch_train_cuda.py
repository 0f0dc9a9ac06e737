"""The port's training kernels on the card against their plain PyTorch
versions: the flash backward (K2 MHA d=72, K4 GQA d=64 causal with a kv
mask), the forward's lse output, and the fused CE forward (K5) and backward
(K6), at small shapes and at the 0.5B training path's shapes.  Needs a CUDA
device; skips without one.

Run on the card (the tests' conftest imports jax, which the card's machine
may lack):
    python -m pytest --noconftest -m cuda tests/test_torch_train_cuda.py

Tolerances: for bf16 outputs, max abs error after an f32 cast <= 2e-2 x
max(1, max |plain|): 8-bit mantissa, and gradients summed over thousands of
rows reach magnitudes above 8, where one bf16 ulp is 0.0625 (both sides
round P and dS to bf16 at the same places and differ in summation order);
2e-3 for the f32 lse/gold rows; and for dW, whose entries are tiny (each
sums 1/N-scaled terms), 2e-2 of its max norm.  Every output is also held by
its relative Frobenius error ||got - plain|| / ||plain|| <= 1e-2, which
sees faults in outputs whose entries are all small (bf16 rounding alone
gives ~2e-3); the tests show that it fails a flash backward that drops
delta and a fused CE backward that drops its softmax term.  The GQA cases
hold K4 (``csrc/flash_bwd_sm90.cu``) at G = 7 with a ragged S, kv tiles
whose every key is masked, non-causal and B = 2; the d = 72 cases hold K2
(``csrc/flash_bwd_d72_sm90.cu``) at S = 63, 64 and 65, S = 729 at B = 2,
causal, with kv tiles whose every key is masked and with a GQA group (at
S = 1 the exact dq and dk are 0, so a relative error has no meaning: that
case is held by max abs error alone); two launches of K2 and K4 must be
bit-identical."""

import pytest
import torch

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops import (
    flash_attention as fa,
    fused_ce as fc,
)

pytestmark = pytest.mark.cuda
TOL = 2e-2
ROW_TOL = 2e-3
REL_TOL = 2e-2
FRO_TOL = 1e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built for sm_90a)")
    return torch.device("cuda", 0)


def _randn(dev, *shape, seed=0, std=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(*shape, generator=g, device=dev) * std).to(torch.bfloat16)


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _fro(a, want):
    """Relative Frobenius error, in f32."""
    return ((a.float() - want.float()).norm() / want.float().norm()).item()


def _close(a, want):
    return (_err(a, want) <= TOL * max(1.0, want.float().abs().max().item())
            and _fro(a, want) <= FRO_TOL)


FLASH_CASES = [
    # (b, sq, hq, hkv, d, causal, n_valid)
    (2, 200, 4, 4, 72, False, None),
    (1, 150, 14, 2, 64, True, 120),
    (2, 65, 2, 1, 64, True, 40),
    (10, 729, 16, 16, 72, False, None),    # SigLIP, the path's shape
    (1, 3072, 14, 2, 64, True, 2936),      # Qwen2 training, the path's shape
    (1, 200, 14, 2, 64, True, 170),        # G = 7 at a ragged S
    (1, 300, 14, 2, 64, True, 100),        # kv tiles 2-4 with every key masked
    (2, 150, 14, 2, 64, False, 120),       # non-causal GQA, B = 2
    (2, 257, 14, 2, 64, True, 250),        # causal GQA, B = 2, a one-row last tile
    (2, 63, 4, 4, 72, False, None),        # d = 72: one row short of a tile
    (2, 64, 4, 4, 72, False, None),        # exactly one tile
    (2, 65, 4, 4, 72, False, None),        # one row past it
    (2, 729, 16, 16, 72, False, None),     # SigLIP's heads at B = 2
    (2, 200, 4, 4, 72, True, None),        # causal
    (1, 300, 4, 4, 72, False, 100),        # kv tiles 2-4 with every key masked
    (1, 200, 4, 4, 72, True, 150),         # causal with a kv mask
    (1, 130, 4, 2, 72, False, 100),        # a GQA group: dk/dv summed over 2 heads in-block
]


@pytest.mark.parametrize("b,s,hq,hkv,d,causal,n_valid", FLASH_CASES)
def test_flash_backward_matches_plain(dev, b, s, hq, hkv, d, causal, n_valid):
    q, k, v = _randn(dev, b, s, hq, d, seed=1), _randn(dev, b, s, hkv, d, seed=2), _randn(dev, b, s, hkv, d, seed=3)
    dout = _randn(dev, b, s, hq, d, seed=4)
    mask = None
    if n_valid is not None:
        mask = torch.zeros(b, s, dtype=torch.bool, device=dev)
        mask[:, :n_valid] = True
    out, lse = fa.flash_attention_ref(q, k, v, mask, causal, return_lse=True)
    delta = fa.attention_delta(out, dout)
    fa.reset_launch_counts()
    got = fa.flash_attention_bwd(q, k, v, dout, lse, delta, mask=mask, causal=causal)
    torch.cuda.synchronize()
    counter = fa.flash_attention_gqa_bwd if hq != hkv else fa.flash_attention_bwd
    assert counter.launches == 1
    lse_n, delta_n = fa.neutralize_dead_rows(lse, delta)
    want = fa.flash_attention_bwd_ref(q, k, v, mask, causal, d**-0.5, lse_n, delta_n, dout)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == w.shape and a.dtype == torch.bfloat16, name
        assert _close(a, w), (name, _err(a, w), _fro(a, w))
    # the check sees a backward that computes dS = P * dP (delta = 0)
    no_delta = fa.flash_attention_bwd(q, k, v, dout, lse, torch.zeros_like(delta), mask=mask, causal=causal)
    assert not _close(no_delta[0], want[0]) and not _close(no_delta[1], want[1])


@pytest.mark.parametrize("b,s,hq,hkv,d,causal,n_valid", [FLASH_CASES[i] for i in (3, 4)], ids=["k2", "k4"])
def test_flash_backward_is_deterministic(dev, b, s, hq, hkv, d, causal, n_valid):
    """Two launches give bit-identical dq, dk and dv (no atomics; K4 sums
    its per-head partials in a fixed order)."""
    q, k, v = _randn(dev, b, s, hq, d, seed=1), _randn(dev, b, s, hkv, d, seed=2), _randn(dev, b, s, hkv, d, seed=3)
    dout = _randn(dev, b, s, hq, d, seed=4, std=0.125)
    mask = torch.zeros(b, s, dtype=torch.bool, device=dev)
    mask[:, :n_valid or s] = True
    out, lse = fa.flash_attention_ref(q, k, v, mask, causal, return_lse=True)
    delta = fa.attention_delta(out, dout)
    first = fa.flash_attention_bwd(q, k, v, dout, lse, delta, mask=mask, causal=causal)
    second = fa.flash_attention_bwd(q, k, v, dout, lse, delta, mask=mask, causal=causal)
    torch.cuda.synchronize()
    for name, a, b_ in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b_), name


@pytest.mark.parametrize("b,s,hq,hkv,d,causal,n_valid", FLASH_CASES[:3])
def test_flash_autograd_uses_both_kernels(dev, b, s, hq, hkv, d, causal, n_valid):
    q, k, v = (_randn(dev, b, s, h, d, seed=i).requires_grad_() for i, h in ((5, hq), (6, hkv), (7, hkv)))
    dout = _randn(dev, b, s, hq, d, seed=8)
    mask = None
    if n_valid is not None:
        mask = torch.zeros(b, s, dtype=torch.bool, device=dev)
        mask[:, :n_valid] = True
    fa.reset_launch_counts()
    out = fa.flash_attention(q, k, v, mask=mask, causal=causal)
    out.backward(dout)
    torch.cuda.synchronize()
    gqa = hq != hkv
    assert (fa.flash_attention_gqa if gqa else fa.flash_attention).launches == 1
    assert (fa.flash_attention_gqa_bwd if gqa else fa.flash_attention_bwd).launches == 1
    ref_out, lse = fa.flash_attention_ref(q.detach(), k.detach(), v.detach(), mask, causal, return_lse=True)
    assert _close(out, ref_out)
    lse_n, delta_n = fa.neutralize_dead_rows(lse, fa.attention_delta(ref_out, dout))
    want = fa.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), mask, causal,
                                      d**-0.5, lse_n, delta_n, dout)
    for name, a, w in zip(("dq", "dk", "dv"), (q.grad, k.grad, v.grad), want):
        assert _close(a, w), (name, _err(a, w), _fro(a, w))


def test_d72_backward_single_key(dev):
    """S = 1: P = 1, so dS = s (dP - delta) = 0 up to rounding and dq, dk are
    0; dv = dO.  Held by max abs error (a relative error of two near-zero
    tensors is noise)."""
    b, s, h, d = 2, 1, 4, 72
    q, k, v = _randn(dev, b, s, h, d, seed=1), _randn(dev, b, s, h, d, seed=2), _randn(dev, b, s, h, d, seed=3)
    dout = _randn(dev, b, s, h, d, seed=4)
    out, lse = fa.flash_attention_ref(q, k, v, None, False, return_lse=True)
    delta = fa.attention_delta(out, dout)
    got = fa.flash_attention_bwd(q, k, v, dout, lse, delta)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_ref(q, k, v, None, False, d**-0.5, lse, delta, dout)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert _err(a, w) <= TOL * max(1.0, w.float().abs().max().item()), name
    assert _close(got[2], dout)


def test_forward_lse_and_dead_rows(dev):
    b, s, hq, hkv, d = 2, 90, 2, 1, 64
    q, k, v = _randn(dev, b, s, hq, d, seed=9), _randn(dev, b, s, hkv, d, seed=10), _randn(dev, b, s, hkv, d, seed=11)
    mask = torch.ones(b, s, dtype=torch.bool, device=dev)
    mask[0] = False
    mask[1, :5] = False
    q.requires_grad_()
    k.requires_grad_()
    v.requires_grad_()
    out = fa.flash_attention(q, k, v, mask=mask, causal=True)
    out.float().square().sum().backward()
    for t in (out, q.grad, k.grad, v.grad):
        assert torch.isfinite(t.float()).all()
    assert (out[0] == 0).all() and (out[1, :5] == 0).all()
    assert (q.grad[0] == 0).all() and (q.grad[1, :5] == 0).all()
    assert (k.grad[0] == 0).all() and (v.grad[1, :5] == 0).all()


CE_CASES = [
    # (n, d, v): ragged last vocab tile of every kernel, ragged row tiles
    (100, 896, 700),
    (130, 896, 1000),
    (3072, 896, 151936),  # the path's shape: B*S rows over the tied head
]


@pytest.mark.parametrize("n,d,v", CE_CASES)
def test_fused_ce_kernels_match_plain(dev, n, d, v):
    h = _randn(dev, n, d, seed=12)
    w = _randn(dev, v, d, seed=13, std=0.02)
    g = torch.Generator(device=dev).manual_seed(14)
    labels = torch.randint(0, v, (n,), generator=g, device=dev, dtype=torch.int32)
    fc.reset_launch_counts()
    lse, gold = fc.lse_gold_fwd(h, w, labels)
    torch.cuda.synchronize()
    want_lse, want_gold = fc.lse_gold_ref(h, w, labels)
    assert _err(lse, want_lse) <= ROW_TOL and _err(gold, want_gold) <= ROW_TOL

    g_lse = torch.full((n,), 1.0 / n, device=dev)
    g_gold = -g_lse
    g_lse[:3] = 0.0  # ignored rows carry zero cotangents
    g_gold[:3] = 0.0
    dh, dw = fc.lse_gold_bwd(h, w, labels, want_lse, g_lse, g_gold)
    torch.cuda.synchronize()
    assert (fc.lse_gold_fwd.launches, fc.lse_gold_bwd.launches) == (1, 1)
    want_dh, want_dw = fc.lse_gold_bwd_ref(h, w, labels, want_lse, g_lse, g_gold)
    assert dh.dtype == dw.dtype == torch.bfloat16
    assert _close(dh, want_dh), (_err(dh, want_dh), _fro(dh, want_dh))
    assert _err(dw, want_dw) <= REL_TOL * want_dw.float().abs().max().item()
    assert _fro(dw, want_dw) <= FRO_TOL

    # g_gold = 0: dh and dW are the softmax term sum_v g_lse p_v w_v alone
    # (the gold term dominates them above), and the check sees a kernel
    # without that term (g_lse = 0)
    g_gold = torch.zeros_like(g_lse)
    want_dh, want_dw = fc.lse_gold_bwd_ref(h, w, labels, want_lse, g_lse, g_gold)
    dh, dw = fc.lse_gold_bwd(h, w, labels, want_lse, g_lse, g_gold)
    assert _close(dh, want_dh), (_err(dh, want_dh), _fro(dh, want_dh))
    assert _fro(dw, want_dw) <= FRO_TOL
    bad_dh, bad_dw = fc.lse_gold_bwd(h, w, labels, want_lse, torch.zeros_like(g_lse), g_gold)
    assert _fro(bad_dh, want_dh) > FRO_TOL and _fro(bad_dw, want_dw) > FRO_TOL


@pytest.mark.parametrize("layout", ["vd", "dv"])
def test_fused_ce_loss_autograd(dev, layout):
    n, d, v = 200, 896, 700
    h = _randn(dev, n, d, seed=15).requires_grad_()
    w_vd = _randn(dev, v, d, seed=16, std=0.02)
    w = (w_vd if layout == "vd" else w_vd.T).clone().requires_grad_()
    labels = torch.arange(n, device=dev) % v
    labels[:7] = fc.IGNORE
    loss = fc.fused_ce_loss(h, w, labels, w_layout=layout)
    loss.backward()
    h32 = h.detach().float().requires_grad_()
    w32 = w_vd.float().requires_grad_()
    want = torch.nn.functional.cross_entropy(h32 @ w32.T, labels, ignore_index=fc.IGNORE)
    want.backward()
    assert abs(loss.item() - want.item()) <= ROW_TOL * max(1.0, abs(want.item()))
    assert w.grad.shape == w.shape
    w_grad_vd = w.grad if layout == "vd" else w.grad.T
    assert _fro(h.grad, h32.grad) <= FRO_TOL and _fro(w_grad_vd, w32.grad) <= FRO_TOL
    assert (h.grad[:7] == 0).all()


def test_fused_ce_refuses_what_it_does_not_take(dev):
    h, w = _randn(dev, 8, 128), _randn(dev, 50, 128)
    labels = torch.zeros(8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="model dim"):
        fc.lse_gold_fwd(h, w, labels)


def test_d72_forward_lse_and_dead_rows(dev):
    """K1's lse and K2 at d = 72 through autograd, with a batch row whose
    every key is masked and rows with no valid key under causality: finite
    outputs and gradients, zeros where no key attends."""
    b, s, h, d = 2, 90, 4, 72
    q, k, v = _randn(dev, b, s, h, d, seed=9), _randn(dev, b, s, h, d, seed=10), _randn(dev, b, s, h, d, seed=11)
    mask = torch.ones(b, s, dtype=torch.bool, device=dev)
    mask[0] = False
    mask[1, :5] = False
    for t in (q, k, v):
        t.requires_grad_()
    out = fa.flash_attention(q, k, v, mask=mask, causal=True)
    out.float().square().sum().backward()
    for t in (out, q.grad, k.grad, v.grad):
        assert torch.isfinite(t.float()).all()
    assert (out[0] == 0).all() and (out[1, :5] == 0).all()
    assert (q.grad[0] == 0).all() and (q.grad[1, :5] == 0).all()
    assert (k.grad[0] == 0).all() and (v.grad[1, :5] == 0).all()
