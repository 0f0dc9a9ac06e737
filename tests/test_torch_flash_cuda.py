"""The port's CUDA flash-attention kernel against its plain PyTorch version on
the card: ragged tiles, GQA groups, causality over a longer cache, kv masks
and rows with no valid key.  Needs a CUDA device; skips without one.

Run on the card (the tests' conftest imports jax, which the card's machine
may lack):
    python -m pytest --noconftest -m cuda tests/test_torch_flash_cuda.py

Tolerance: max abs error 2e-2 after an f32 cast — bf16 output (8-bit
mantissa) of values of magnitude up to ~4, and the kernel rounds the
probabilities to bf16 before the PV product."""

import pytest
import torch

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops import (
    flash_attention as fa,
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
