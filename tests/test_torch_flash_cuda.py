"""The port's CUDA flash-attention kernels against their plain PyTorch version
on the card: ragged tiles, GQA groups, causality over a longer cache, kv
masks and rows with no valid key.  Head dim 72 (K1, SigLIP) runs the
wgmma/TMA kernel of ``csrc/flash_fwd_sm90.cu``: S = 1, 63, 64 and 65 (one
q tile of a 128-row block, a full 64-row kv tile, one row past it), S = 729
at B = 2, causality with Sq != Skv, kv masks with whole kv tiles masked, a
GQA group, with and without the lse, and two launches bit-identical.  Head
dims 64 and 128 (K3) run the wgmma/TMA kernel of ``csrc/flash_gqa_sm90.cuh``
(persistent, tiles drawn from a counter): a ragged S = 200, Sq < Skv, kv
masks with B > 1 and different valid lengths, a batch row with no valid key
(zeros and lse -inf), the lse against the plain logsumexp, the output with
the lse bit-identical to the output without it, two launches
bit-identical; K13's ``full`` arm is the same kernel, bit for bit.  Needs a
CUDA device; skips without one.

Run on the card (the tests' conftest imports jax, which the card's machine
may lack):
    python -m pytest --noconftest -m cuda tests/test_torch_flash_cuda.py

Tolerance: max abs error 2e-2 after an f32 cast — bf16 output (8-bit
mantissa) of values of magnitude up to ~4, and the kernel rounds the
probabilities to bf16 before the PV product; the lse within 1e-3 (f32 sums
in another order)."""

import pytest
import torch

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops import (
    _build,
    flash_attention as fa,
    flash_phase_ablation as k13,
)

pytestmark = pytest.mark.cuda
TOL = 2e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel is built for sm_90a)")
    return torch.device("cuda", 0)


def _qkv(dev, b, sq, skv, hq, hkv, d, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)  # noqa: E731
    return mk(b, sq, hq, d), mk(b, skv, hkv, d), mk(b, skv, hkv, d)


CASES = [
    # (b, sq, skv, hq, hkv, d, causal, n_valid)
    (2, 729, 729, 4, 4, 72, False, None),   # SigLIP-like, ragged last tile
    (1, 65, 65, 3, 3, 72, True, None),
    (1, 1, 1, 4, 4, 72, False, None),       # d = 72: one row, one key
    (2, 63, 63, 4, 4, 72, False, None),     # one row short of a kv tile
    (2, 64, 64, 4, 4, 72, False, None),     # exactly one kv tile
    (2, 65, 65, 4, 4, 72, False, None),     # one row past it
    (2, 200, 200, 4, 4, 72, True, None),    # causal, both warpgroups' diagonals
    (1, 100, 230, 2, 2, 72, True, None),    # causal over a longer cache
    (2, 300, 300, 4, 4, 72, False, 100),    # kv tiles 2-4 with every key masked
    (1, 200, 232, 4, 4, 72, True, 150),     # causal with a kv mask
    (1, 130, 130, 4, 2, 72, False, 100),    # a GQA group at d = 72
    (2, 200, 232, 14, 2, 64, True, 150),    # prefill-like: GQA 7, cache > prompt
    (1, 128, 128, 2, 1, 64, False, 64),
    (3, 1, 97, 14, 2, 64, False, 40),       # single query row
    (1, 200, 232, 28, 4, 128, True, 150),   # the 7B teacher's prefill heads
]


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,n_valid", CASES)
def test_kernel_matches_plain(dev, b, sq, skv, hq, hkv, d, causal, n_valid):
    q, k, v = _qkv(dev, b, sq, skv, hq, hkv, d)
    mask = None
    if n_valid is not None:
        mask = torch.zeros(b, skv, dtype=torch.bool, device=dev)
        mask[:, :n_valid] = True
    fa.reset_launch_counts()
    got = fa.flash_attention(q, k, v, mask=mask, causal=causal)
    torch.cuda.synchronize()
    counted = fa.flash_attention_gqa.launches if hq != hkv else fa.flash_attention.launches
    assert counted == 1
    want = fa.flash_attention_ref(q, k, v, mask, causal)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert (got.float() - want.float()).abs().max().item() <= TOL


def test_rows_without_a_valid_key_are_zero(dev):
    q, k, v = _qkv(dev, 2, 70, 90, 2, 1, 64, seed=1)
    mask = torch.ones(2, 90, dtype=torch.bool, device=dev)
    mask[0] = False
    mask[1, :5] = False
    got = fa.flash_attention(q, k, v, mask=mask, causal=True)
    want = fa.flash_attention_ref(q, k, v, mask, True)
    assert torch.isfinite(got.float()).all()
    assert (got[0] == 0).all() and (got[1, :5] == 0).all()
    assert (got.float() - want.float()).abs().max().item() <= TOL


def test_kernel_refuses_what_it_does_not_take(dev):
    q, k, v = _qkv(dev, 1, 16, 16, 2, 2, 64)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention(q.float(), k.float(), v.float())
    q, k, v = _qkv(dev, 1, 16, 16, 2, 2, 32)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, k, v)


D72_LSE_CASES = [
    # (b, sq, skv, causal, n_valid): the SigLIP shape, and a ragged causal
    # case whose first batch row has no valid key (lse -inf, output 0)
    (10, 729, 729, False, None),
    (2, 130, 150, True, 0),
]


@pytest.mark.parametrize("b,sq,skv,causal,n_valid", D72_LSE_CASES)
def test_d72_forward_lse(dev, b, sq, skv, causal, n_valid):
    """The lse the backward reads, against the plain logsumexp; the output
    with the lse bit-identical to the output without it."""
    hq = 16 if sq == 729 else 4
    q, k, v = _qkv(dev, b, sq, skv, hq, hq, 72, seed=2)
    mask = None
    if n_valid is not None:
        mask = torch.ones(b, skv, dtype=torch.bool, device=dev)
        mask[0] = False
    want, want_lse = fa.flash_attention_ref(q, k, v, mask, causal, return_lse=True)
    mask_u8 = None if mask is None else mask.view(torch.uint8)
    out, lse = torch.empty_like(q), torch.empty(b, hq, sq, device=dev)
    _build.flash_fwd(q, k, v, mask_u8, out, lse, causal, 72**-0.5)
    bare = torch.empty_like(q)
    _build.flash_fwd(q, k, v, mask_u8, bare, None, causal, 72**-0.5)
    torch.cuda.synchronize()
    assert (out.float() - want.float()).abs().max().item() <= TOL
    assert torch.equal(out, bare)
    live = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), live)
    assert (lse[live] - want_lse[live]).abs().max().item() <= 1e-3
    if n_valid is not None:
        assert torch.isneginf(lse[0]).all() and (out[0] == 0).all()


def test_d72_forward_is_deterministic(dev):
    q, k, v = _qkv(dev, 10, 729, 729, 16, 16, 72, seed=3)
    first = fa.flash_attention(q, k, v)
    second = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


K3_CASES = [
    # (b, sq, skv, hq, hkv, causal, valid keys per batch row or None)
    (2, 200, 200, 4, 2, True, None),            # ragged S, no mask
    (1, 100, 230, 14, 2, True, None),           # Sq < Skv, causal over a longer cache
    (3, 130, 230, 14, 2, True, [230, 150, 61]),  # B > 1, different valid lengths
    (2, 200, 200, 14, 2, False, [200, 77]),     # a kv mask without causality
    (8, 65, 300, 7, 1, True, [300, 260, 211, 180, 150, 99, 70, 64]),  # the evaluator's B = 8 over ragged prompts
]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,causal,lengths", K3_CASES)
def test_k3_matches_plain_with_and_without_lse(dev, d, b, sq, skv, hq, hkv, causal, lengths):
    """K3's output against the plain version, its lse against the plain
    logsumexp, the output written with the lse bit-identical to the one
    written without it, and two launches bit-identical."""
    q, k, v = _qkv(dev, b, sq, skv, hq, hkv, d, seed=5)
    mask = None
    if lengths is not None:
        mask = torch.arange(skv, device=dev)[None, :] < torch.tensor(lengths, device=dev)[:, None]
    with torch.no_grad():
        got = fa.flash_attention_gqa(q, k, v, mask=mask, causal=causal)
        again = fa.flash_attention_gqa(q, k, v, mask=mask, causal=causal)
    out, lse = torch.empty_like(q), torch.empty(b, hq, sq, device=dev)
    _build.flash_fwd(q, k, v, None if mask is None else mask.view(torch.uint8), out, lse, causal, d**-0.5)
    torch.cuda.synchronize()
    want, want_lse = fa.flash_attention_ref(q, k, v, mask, causal, return_lse=True)
    assert (got.float() - want.float()).abs().max().item() <= TOL
    assert torch.equal(got, again) and torch.equal(out, got)
    live = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), live)
    assert (lse[live] - want_lse[live]).abs().max().item() <= 1e-3


@pytest.mark.parametrize("d", [64, 128])
def test_k3_rows_without_a_valid_key(dev, d):
    """A batch row whose keys are all masked outputs zeros and lse -inf; so do
    the first rows of a row whose first keys are masked under causality."""
    q, k, v = _qkv(dev, 2, 150, 180, 14, 2, d, seed=6)
    mask = torch.ones(2, 180, dtype=torch.bool, device=dev)
    mask[0] = False
    mask[1, :70] = False
    out, lse = torch.empty_like(q), torch.empty(2, 14, 150, device=dev)
    _build.flash_fwd(q, k, v, mask.view(torch.uint8), out, lse, True, d**-0.5)
    torch.cuda.synchronize()
    want = fa.flash_attention_ref(q, k, v, mask, True)
    assert torch.isfinite(out.float()).all()
    assert (out[0] == 0).all() and (out[1, :70] == 0).all()
    assert torch.isneginf(lse[0]).all() and torch.isneginf(lse[1, :, :70]).all()
    assert torch.isfinite(lse[1, :, 70:]).all()
    assert (out.float() - want.float()).abs().max().item() <= TOL


@pytest.mark.parametrize("d", [64, 128])
def test_k3_keeps_the_k13_full_arm_kernel(dev, d):
    """K3 and K13's ``full`` arm are one instantiation of
    flash_gqa_sm90.cuh's kernel: the same bits at a ragged S."""
    q, k, v = _qkv(dev, 2, 200, 200, 4, 2, d, seed=4)
    with torch.no_grad():
        k3 = fa.flash_attention_gqa(q, k, v, causal=True)
    assert torch.equal(k13.phase_ablation_forward(q, k, v, "full"), k3)
