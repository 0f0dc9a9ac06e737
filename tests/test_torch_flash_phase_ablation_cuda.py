"""K13 on the card (``csrc/flash_phase_ablation_d*.cu``: the phase-ablation
arms of the causal flash forward, ``csrc/flash_gqa_sm90.cuh``'s template
parameter ARM) against its plain versions at small shapes, ragged sequences
included (S = 449 at d=64 ends in a 65-row q tile of the 192-row blocks, so
one warpgroup has no rows and one has one).

* every arm at d=64 and d=128 against ``phase_ablation_ref`` at the
  kernel's tiling (``KERNEL_BLOCK``: 64-row warpgroups, the kernel's kv
  tiles): max abs error <= 2e-2 x max(1, max |plain|) and relative
  Frobenius error <= 1e-2 where both are finite, non-finite at the same
  positions (noexp and mxu put masked scores into the PV product; every
  other arm is finite);
* the exact arms against ``full``, and ``full`` bit-equal to K3
  (``flash_attention_gqa``, no mask);
* the wrapper's refusals: an unknown arm, Sq != Skv, a head dim it has no
  kernel for.

Needs a CUDA device; skips without one.  Run on the card (the tests'
conftest imports jax, which the card's machine may lack):
    python -m pytest --noconftest -m cuda tests/test_torch_flash_phase_ablation_cuda.py"""

import pytest
import torch

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops import (
    flash_attention as fa,
    flash_phase_ablation as k13,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built for sm_90a)")
    return torch.device("cuda", 0)


def _inputs(dev, b, s, hq, hkv, d, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(b, s, h, d, generator=g, device=dev).to(torch.bfloat16) for h in (hq, hkv, hkv))


@pytest.mark.parametrize("shape", [(2, 320, 4, 2, 64), (1, 200, 6, 2, 128), (1, 449, 14, 2, 64), (1, 333, 28, 4, 128)],
                         ids=["d64", "d128_ragged", "d64_ragged_tile", "d128_teacher_heads"])
@pytest.mark.parametrize("arm", k13.ARMS)
def test_arm_matches_its_plain_version(dev, shape, arm):
    q, k, v = _inputs(dev, *shape)
    got = k13.phase_ablation_forward(q, k, v, arm)
    torch.cuda.synchronize()
    check = k13.check_arm(got, k13.phase_ablation_ref(q, k, v, arm), arm)
    assert check is not None, "non-finite at other positions than the plain version"
    err, tol, fro = check
    assert err <= tol and fro <= 1e-2, check
    if arm in k13.EXACT_ARMS:
        full = k13.phase_ablation_forward(q, k, v, "full")
        assert (got.float() - full.float()).abs().max().item() <= k13.TOL


@pytest.mark.parametrize("d", [64, 128])
def test_full_is_k3(dev, d):
    q, k, v = _inputs(dev, 1, 448, 4, 2, d, seed=1)
    with torch.no_grad():
        k3 = fa.flash_attention_gqa(q, k, v, causal=True)
    assert torch.equal(k13.phase_ablation_forward(q, k, v, "full"), k3)


def test_wrapper_refusals(dev):
    q, k, v = _inputs(dev, 1, 128, 4, 2, 64)
    with pytest.raises(ValueError, match="unknown arm"):
        k13.phase_ablation_forward(q, k, v, "nothing")
    with pytest.raises(ValueError, match="Sq == Skv"):
        k13.phase_ablation_forward(q, k[:, :64].contiguous(), v[:, :64].contiguous(), "full")
    q72, k72, v72 = _inputs(dev, 1, 128, 4, 2, 72)
    with pytest.raises(ValueError, match="head dim"):
        k13.phase_ablation_forward(q72, k72, v72, "full")
