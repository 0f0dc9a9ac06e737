"""K13's plain versions (``ops/flash_phase_ablation.py``: every arm of the
causal flash forward's phase ablation) on the CPU against the JAX script's
arms (``scripts/flash_phase_ablation.py``: ``build``), run in Pallas
interpret mode with the blocks pinned to ``_GQA_ROWS = 256`` and
``_GQA_BK = 128``: 4 x 4 blocks at B=1, 2 kv heads of 2 q heads, S=512,
d=64.  The plain version walks the JAX build's tiles and fills masked
scores as the JAX arm does.

Two masked-score fills are compared.  The JAX kernels' own (MASK_VALUE,
-0.7 x the f32 maximum): every arm agrees within max abs 2e-2 x max(1,
|JAX|) on its bf16 output; ``noexp`` and ``mxu`` put ~3e37-sized masked
products into f32 sums that overflow or not depending on the order XLA and
PyTorch sum in, so there they are held only where both sides are finite.
And -inf, the port's kernel's fill (the JAX module's MASK_VALUE patched for
the test): infinities propagate whatever the order, so every arm is also
held by identical non-finite positions.

The exact arms are also held to the port's ``flash_attention_ref``, and the
tiling dependence of an arm that is not attention is shown."""

import functools
import importlib.util
import os
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.ops import (
    flash_attention as jfa,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops import (
    flash_attention as fa,
    flash_phase_ablation as k13,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, HKV, G, S, D = 1, 2, 2, 512, 64
TOL = 2e-2


@pytest.fixture(scope="module")
def script():
    """The JAX script as a module; it sets KDSS_FLASH_* defaults in
    os.environ when imported, which are undone here."""
    with mock.patch.dict(os.environ):
        spec = importlib.util.spec_from_file_location(
            "flash_phase_ablation_script", os.path.join(REPO, "scripts", "flash_phase_ablation.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, S, HKV * G, D)).astype(np.float32)
    k = rng.standard_normal((B, S, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, HKV, D)).astype(np.float32)
    return tuple(torch.tensor(x).to(torch.bfloat16) for x in (q, k, v))


def _jax_arm(script, monkeypatch, arm, q, k, v, fill):
    """The JAX arm's output in the port's layout [B, S, Hq, D] (f32), and its
    blocks (bq, bk)."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(jfa, "_GQA_ROWS", 256)
    monkeypatch.setattr(jfa, "_GQA_BK", 128)
    if fill != k13.JAX_MASK_VALUE:
        monkeypatch.setattr(jfa, "MASK_VALUE", fill)
    call, (bq, bk, _, _) = script.build(arm, B, HKV, G, S, D)
    jq = jnp.asarray(q.float().numpy()).astype(jnp.bfloat16).reshape(B, S, HKV, G, D).transpose(0, 2, 3, 1, 4)
    jk, jv = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16).transpose(0, 2, 1, 3) for x in (k, v))
    out = np.asarray(call(jq, jk, jv)[0].astype(jnp.float32))
    return torch.tensor(out.transpose(0, 3, 1, 2, 4).reshape(B, S, HKV * G, D)), (bq, bk)


@pytest.mark.parametrize("fill", [k13.JAX_MASK_VALUE, float("-inf")], ids=["mask_value", "neg_inf"])
@pytest.mark.parametrize("arm", k13.ARMS)
def test_plain_arm_matches_the_jax_arm(script, inputs, monkeypatch, arm, fill):
    q, k, v = inputs
    want, (bq, bk) = _jax_arm(script, monkeypatch, arm, q, k, v, fill)
    assert (bq, bk) == (128, 128)
    got = k13.phase_ablation_ref(q, k, v, arm, bq=bq, bk=bk, fill=fill).float()
    assert got.shape == want.shape
    fin_g, fin_w = torch.isfinite(got), torch.isfinite(want)
    if arm in k13.NONFINITE_ARMS:
        assert not bool(fin_w.all())  # masked scores reach the output
        if fill != k13.JAX_MASK_VALUE:
            assert torch.equal(fin_g, fin_w)
    else:
        assert bool(fin_w.all()) and bool(fin_g.all())
    both = fin_g & fin_w
    assert bool(both.any())
    err = ((got - want).abs() / want.abs().clamp(min=1.0))[both].max().item()
    assert err <= TOL, (arm, err)


@pytest.mark.parametrize("arm", k13.EXACT_ARMS)
def test_exact_arms_are_attention(inputs, arm):
    """At the JAX build's tiling and at the kernel's, the arms that compute
    attention agree with the port's ``flash_attention_ref``."""
    q, k, v = inputs
    want = fa.flash_attention_ref(q, k, v, None, causal=True).float()
    for bq, bk in ((128, 128), k13.KERNEL_BLOCK[D]):
        got = k13.phase_ablation_ref(q, k, v, arm, bq=bq, bk=bk).float()
        assert (got - want).abs().max().item() <= TOL, (arm, bq, bk)


def test_an_arm_that_is_not_attention_depends_on_the_tiling(inputs):
    q, k, v = inputs
    a = k13.phase_ablation_ref(q, k, v, "noalpha", bq=128, bk=128).float()
    b = k13.phase_ablation_ref(q, k, v, "noalpha", bq=128, bk=512).float()
    assert (a - b).abs().max().item() > 10 * TOL


def test_wrapper_runs_the_plain_version_on_the_cpu(inputs):
    """On a CPU tensor the wrapper is the plain version at the kernel's
    tiling and fill, and counts no launch; an unknown arm raises."""
    q, k, v = inputs
    k13.reset_launch_counts()
    for arm in ("full", "nosum", "mxu"):
        got = k13.phase_ablation_forward(q, k, v, arm)
        bq, bk = k13.KERNEL_BLOCK[D]
        want = k13.phase_ablation_ref(q, k, v, arm, bq=bq, bk=bk, fill=float("-inf"))
        assert torch.equal(torch.isfinite(got), torch.isfinite(want))
        assert torch.equal(got[torch.isfinite(got)], want[torch.isfinite(want)])
    assert k13.phase_ablation_forward.launches == 0
    with pytest.raises(ValueError, match="unknown arm"):
        k13.phase_ablation_forward(q, k, v, "nothing")


def test_accounting_lines():
    """The JAX script's report: the seven deltas, then the phase accounting
    against the tensor-core floor (K3's bound at the student's shape)."""
    ms = dict.fromkeys(k13.ARMS, 0.1)
    ms.update(full=0.2, noexp=0.15, nored=0.12, mxu=0.08)
    lines = k13.accounting(ms, 3072, 14, 64)
    assert len(lines) == 7 + 6
    assert lines[7] == "phase accounting (ms/pass):"
    assert "exp (transcendental)     0.0500" in lines[8]
    assert "softmax total            0.1200" in lines[10]
    assert abs(k13.tensor_core_floor_ms(3072, 14, 64) - 0.0171) < 1e-4
    assert abs(k13.tensor_core_floor_ms(3072, 28, 128) - 0.0684) < 1e-4


@pytest.mark.parametrize("d", [64, 128])
def test_kernel_block_is_the_kernels_tiling(d):
    """The plain walk's default tiling is the kernel's: 64-row warpgroups over
    kv tiles of the kernel's width (csrc/flash_gqa_sm90.cuh, Shape<D>)."""
    assert k13.KERNEL_BLOCK[d] == (64, fa.GQA_SHAPES[d][1])


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("arm", k13.EXACT_ARMS)
def test_exact_arms_at_the_kernel_blocks(arm, d):
    """At the kernel's tiling of each head dim, at a ragged S (the last kv tile
    and the last warpgroup's rows partial), the arms that compute attention
    agree with ``flash_attention_ref``; the default tiling is the kernel's."""
    rng = np.random.default_rng(d)
    q, k, v = (torch.tensor(rng.standard_normal((1, 200, h, d)).astype(np.float32)).to(torch.bfloat16)
               for h in (4, 2, 2))
    want = fa.flash_attention_ref(q, k, v, None, causal=True).float()
    bq, bk = k13.KERNEL_BLOCK[d]
    got = k13.phase_ablation_ref(q, k, v, arm, bq=bq, bk=bk)
    assert torch.equal(got, k13.phase_ablation_ref(q, k, v, arm))
    assert (got.float() - want).abs().max().item() <= TOL, (arm, d)
