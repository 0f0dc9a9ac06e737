"""The port's fused cross-entropy on the CPU (the plain versions of the K5/K6
kernels under their autograd Function) against the JAX package's Pallas
``fused_ce_loss`` in interpret mode, for both head layouts and a ragged
last vocab tile, plus the port's masked CE against the JAX one.

Inputs come from a seeded numpy generator, in float32.  Tolerances are
those of tests/test_fused_ce.py: rtol 1e-5 on the value, atol 1e-5 and rtol
1e-4 on the gradients."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.losses import (
    kd_losses as jax_losses,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.ops.fused_ce import (
    fused_ce_loss as jax_fused_ce_loss,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.losses import (
    kd_losses,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops import (
    fused_ce as fc,
)


def _inputs(n, d, v, layout, seed):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(n, d)).astype(np.float32)
    w = (rng.normal(size=(d, v)) * 0.05).astype(np.float32)
    if layout == "vd":
        w = np.ascontiguousarray(w.T)
    labels = rng.integers(0, v, size=(n,)).astype(np.int32)
    labels[:5] = -100
    return h, w, labels


@pytest.fixture(autouse=True)
def zero_counts():
    fc.reset_launch_counts()
    yield
    assert fc.lse_gold_fwd.launches == 0 and fc.lse_gold_bwd.launches == 0


# (n, d, v, layout): v = 700 leaves a ragged last tile of the JAX kernel's
# 512-wide vocab blocks (and of every CUDA kernel's tiles)
@pytest.mark.parametrize("n,d,v,layout", [
    (64, 128, 300, "dv"),
    (64, 128, 300, "vd"),
    (100, 96, 700, "vd"),
])
def test_fused_ce_matches_jax_interpret(n, d, v, layout):
    h, w, labels = _inputs(n, d, v, layout, seed=0)
    jl = jnp.asarray(labels)

    def jax_loss(h_, w_):
        return jax_fused_ce_loss(h_, w_, jl, w_layout=layout)

    with pltpu.force_tpu_interpret_mode():
        want, (want_dh, want_dw) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
            jnp.asarray(h), jnp.asarray(w))

    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    got = fc.fused_ce_loss(th, tw, torch.from_numpy(labels), w_layout=layout)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(want_dh), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_dw), atol=1e-5, rtol=1e-4)


def test_plain_versions_keep_to_one_chunk():
    """lse/gold and the backward are the same at any row chunk (the plain
    versions never hold more than a chunk of logits)."""
    h, w, labels = _inputs(50, 32, 90, "vd", seed=1)
    h, w, labels = map(torch.from_numpy, (h, w, labels))
    safe = labels.clamp(min=0)
    full = fc.lse_gold_ref(h, w, safe, chunk=50)
    parts = fc.lse_gold_ref(h, w, safe, chunk=7)
    for a, b in zip(full, parts):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    g = torch.linspace(-1, 1, 50)
    bfull = fc.lse_gold_bwd_ref(h, w, safe, full[0], g, -g, chunk=50)
    bparts = fc.lse_gold_bwd_ref(h, w, safe, full[0], g, -g, chunk=7)
    for a, b in zip(bfull, bparts):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_ignored_rows_contribute_nothing():
    h, w, labels = _inputs(20, 16, 40, "vd", seed=2)
    labels[:] = -100
    labels[3] = 7
    th = torch.from_numpy(h).requires_grad_()
    loss = fc.fused_ce_loss(th, torch.from_numpy(w), torch.from_numpy(labels), w_layout="vd")
    loss.backward()
    row = torch.from_numpy(h[3]) @ torch.from_numpy(w).T
    torch.testing.assert_close(loss, torch.logsumexp(row, 0) - row[7], atol=1e-6, rtol=0)
    assert (th.grad[:3] == 0).all() and (th.grad[4:] == 0).all()
    all_ignored = torch.full((20,), -100)
    assert fc.fused_ce_loss(th, torch.from_numpy(w), all_ignored, w_layout="vd").item() == 0.0


def test_fused_ce_refuses_a_bad_layout():
    with pytest.raises(ValueError, match="w_layout"):
        fc.fused_ce_sum(torch.zeros(2, 4), torch.zeros(4, 3), torch.zeros(2, dtype=torch.long), "dd")


def test_kernel_args_reject_what_the_kernels_do_not_take():
    h, w = torch.zeros(8, 96, dtype=torch.bfloat16), torch.zeros(50, 96, dtype=torch.bfloat16)
    labels = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="model dim"):
        fc.kernel_args(h, w, labels)
    h, w = torch.zeros(8, 896, dtype=torch.bfloat16), torch.zeros(50, 896, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        fc.kernel_args(h, w, labels)
    with pytest.raises(ValueError, match="int32"):
        fc.kernel_args(h, w, labels.long())


def test_masked_cross_entropy_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 9, 30)).astype(np.float32)
    labels = rng.integers(0, 30, size=(2, 9)).astype(np.int32)
    labels[0, :4] = -100
    want = jax_losses.masked_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = kd_losses.masked_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
