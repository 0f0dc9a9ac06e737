"""The port's fused temperature KL (K7/K8's plain versions, ``ops/fused_kl.py``)
on the CPU against the JAX package's ``fused_kl_loss`` with
``teacher_logits="materialize"`` and the "vd" head, run as its own tests run
it (Pallas in interpret mode), at the shapes of ``tests/test_fused_kl.py``
(a teacher vocab wider than the student's, V not a multiple of 128, T = 1.0
and 0.8); and the port's ``kd_kl_loss``, ``pool_and_normalize``,
``ntxent_loss`` and ``masked_ntxent_loss`` against the JAX package's, values
and gradients, with padded all-zero tiles whose gradient must stay finite.

The JAX call takes the teacher's (hidden, head); the port takes the teacher
logits built from the same arrays, ``ht @ wt[:, :V] / T`` in float32.
Tolerances as for the plain K11 (``tests/test_torch_fused_loca_ce.py``):
values rtol 2e-5 / atol 1e-6, gradients rtol 2e-4 / atol 2e-6 (both sides
f32, summation order only)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.losses import (
    kd_losses as jax_losses,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.ops.fused_kl import (
    fused_kl_loss as jax_fused_kl_loss,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.losses import (
    kd_kl_loss,
    masked_ntxent_loss,
    ntxent_loss,
    pool_and_normalize,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops import (
    fused_kl as fkl,
)

VALUE_TOL = dict(rtol=2e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-4, atol=2e-6)
SHAPES = [(64, 128, 256, 300, 340, 1.0), (50, 96, 96, 513, 513, 0.8)]


def _arrays(n, ds, dt, v, vt, seed=0):
    rng = np.random.default_rng(seed)
    hs = rng.normal(size=(n, ds)).astype(np.float32)
    ht = rng.normal(size=(n, dt)).astype(np.float32)
    ws = rng.normal(size=(ds, v)).astype(np.float32) * 0.05
    wt = rng.normal(size=(dt, vt)).astype(np.float32) * 0.05
    return hs, ht, ws, wt


def _port(hs, ht, ws, wt, temp):
    th = torch.tensor(hs, requires_grad=True)
    tw = torch.tensor(np.ascontiguousarray(ws.T), requires_grad=True)
    tmat = torch.from_numpy(ht @ wt[:, :ws.shape[1]]) / temp
    loss = fkl.fused_kl_loss(th, tw, tmat, temperature=temp)
    gh, gw = torch.autograd.grad(loss, (th, tw))
    return loss.item(), gh.numpy(), gw.numpy()


@pytest.mark.parametrize("n,ds,dt,v,vt,temp", SHAPES)
def test_plain_k7_k8_match_the_jax_kernels(n, ds, dt, v, vt, temp):
    hs, ht, ws, wt = _arrays(n, ds, dt, v, vt)

    def f(h, w):
        return jax_fused_kl_loss(h, w, jnp.asarray(ht), jnp.asarray(wt), temperature=temp,
                                 student_head_layout="vd", teacher_logits="materialize")

    with pltpu.force_tpu_interpret_mode():
        want, (wh, ww) = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(hs), jnp.asarray(ws.T))
    got, gh, gw = _port(hs, ht, ws, wt, temp)
    np.testing.assert_allclose(got, float(want), **VALUE_TOL)
    np.testing.assert_allclose(gh, np.asarray(wh), err_msg="d hs", **GRAD_TOL)
    np.testing.assert_allclose(gw, np.asarray(ww), err_msg="d ws [V, D]", **GRAD_TOL)


@pytest.mark.parametrize("n,ds,dt,v,vt,temp", SHAPES)
def test_plain_kl_rows_equal_dense_kd_kl_loss(n, ds, dt, v, vt, temp):
    """The plain K7 in chunks of 7 rows (so several chunks and a ragged last
    one) against the dense ``kd_kl_loss`` of the port and of the JAX
    package; its lse outputs against torch.logsumexp; the plain K8 against
    autograd of the dense loss, and without dW when the head needs none."""
    hs, ht, ws, wt = _arrays(n, ds, dt, v, vt, seed=1)
    th, tw = torch.tensor(hs, requires_grad=True), torch.tensor(np.ascontiguousarray(ws.T))
    tw.requires_grad_(True)
    s_logits, t_logits = th @ tw.T, torch.from_numpy(ht @ wt)
    tmat = t_logits[:, :v] / temp
    kl, lse_s, lse_t = fkl.kl_rows_ref(th.detach(), tw.detach(), tmat, inv_t=1 / temp, chunk=7)
    dense = kd_kl_loss(s_logits[None], t_logits[None], temp)
    want = float(jax_losses.kd_kl_loss(jnp.asarray(hs @ ws)[None], jnp.asarray(ht @ wt)[None], temp))
    np.testing.assert_allclose(dense.item(), want, **VALUE_TOL)
    np.testing.assert_allclose((kl.sum() / (n * v) * temp**2).item(), want, **VALUE_TOL)
    np.testing.assert_allclose(lse_s.numpy(), torch.logsumexp(s_logits / temp, -1).detach().numpy(),
                               **VALUE_TOL)
    np.testing.assert_allclose(lse_t.numpy(), torch.logsumexp(tmat, -1).numpy(), **VALUE_TOL)

    rh, rw = torch.autograd.grad(dense, (th, tw))
    g = torch.full((n,), temp**2 / (n * v))
    dh, dw = fkl.kl_rows_bwd_ref(th.detach(), tw.detach(), tmat, lse_s, lse_t, g, inv_t=1 / temp, chunk=7)
    np.testing.assert_allclose(dh.numpy(), rh.numpy(), err_msg="dh", **GRAD_TOL)
    np.testing.assert_allclose(dw.numpy(), rw.numpy(), err_msg="dW", **GRAD_TOL)
    dh2, dw2 = fkl.kl_bwd(th.detach(), tw.detach(), tmat, lse_s, lse_t, g, inv_t=1 / temp, need_dw=False)
    assert dw2 is None and torch.allclose(dh2, dh, rtol=1e-6, atol=1e-9)


def test_frozen_head_gets_no_gradient():
    """A head that needs no gradient (phase 1's frozen embedding) is not
    differentiated: autograd returns dh alone, equal to the full case's."""
    hs, ht, ws, wt = _arrays(20, 32, 32, 70, 70, seed=2)
    tmat = torch.from_numpy(ht @ wt) / 0.8
    th = torch.tensor(hs, requires_grad=True)
    tw = torch.tensor(np.ascontiguousarray(ws.T))
    (gh,) = torch.autograd.grad(fkl.fused_kl_loss(th, tw, tmat, temperature=0.8), (th,))
    tw.requires_grad_(True)
    gh2, _ = torch.autograd.grad(fkl.fused_kl_loss(th, tw, tmat, temperature=0.8), (th, tw))
    assert torch.equal(gh, gh2)
    assert fkl.kl_fwd.launches == fkl.kl_bwd.launches == fkl.kl_bwd.dw_launches == 0  # CPU never counts


@pytest.mark.parametrize("temp", [0.8, 1.0])
def test_kd_kl_loss_matches_jax(temp):
    rng = np.random.default_rng(5)
    t = rng.normal(size=(2, 7, 40)).astype(np.float32) * 3
    s = rng.normal(size=(2, 7, 33)).astype(np.float32)  # teacher vocab + 7: truncated
    want_v, want_g = jax.value_and_grad(lambda x: jax_losses.kd_kl_loss(x, jnp.asarray(t), temp))(
        jnp.asarray(s))
    ts = torch.tensor(s, requires_grad=True)
    got = kd_kl_loss(ts, torch.from_numpy(t), temp)
    (g,) = torch.autograd.grad(got, (ts,))
    np.testing.assert_allclose(got.item(), float(want_v), **VALUE_TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), **GRAD_TOL)


def _features(n, d, seed, zero_rows=()):
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(n, d)).astype(np.float32)
    t = rng.normal(size=(n, d)).astype(np.float32)
    s[list(zero_rows)] = 0.0
    t[list(zero_rows)] = 0.0
    return s, t


@pytest.mark.parametrize("zero_rows", [(), (5, 6, 7)], ids=["dense", "padded"])
def test_masked_ntxent_matches_jax(zero_rows):
    """The per-tile NT-Xent of phase 1: padded tiles are all-zero rows, masked
    out of the similarity columns and the mean; the gradient at them is
    finite (zero), as the JAX ``_l2_normalize`` makes it."""
    n, d = 8, 24
    s, t = _features(n, d, seed=3, zero_rows=zero_rows)
    valid = np.ones(n, bool)
    valid[list(zero_rows)] = False
    jf = lambda x: jax_losses.masked_ntxent_loss(x, jnp.asarray(t), jnp.asarray(valid), 0.07)  # noqa: E731
    want_v, want_g = jax.value_and_grad(jf)(jnp.asarray(s))
    ts = torch.tensor(s, requires_grad=True)
    got = masked_ntxent_loss(ts, torch.from_numpy(t), torch.from_numpy(valid), 0.07)
    (g,) = torch.autograd.grad(got, (ts,))
    assert torch.isfinite(g).all()
    np.testing.assert_allclose(got.item(), float(want_v), **VALUE_TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), **GRAD_TOL)
    if zero_rows:
        assert (g[list(zero_rows)] == 0).all()


def test_ntxent_and_pooling_match_jax():
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(6, 9, 16)).astype(np.float32)
    np.testing.assert_allclose(pool_and_normalize(torch.from_numpy(feats)).numpy(),
                               np.asarray(jax_losses.pool_and_normalize(jnp.asarray(feats))), **VALUE_TOL)
    s, t = _features(6, 16, seed=6)
    want_v, want_g = jax.value_and_grad(lambda x: jax_losses.ntxent_loss(x, jnp.asarray(t), 0.07))(
        jnp.asarray(s))
    ts = torch.tensor(s, requires_grad=True)
    got = ntxent_loss(ts, torch.from_numpy(t), 0.07)
    (g,) = torch.autograd.grad(got, (ts,))
    np.testing.assert_allclose(got.item(), float(want_v), **VALUE_TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), **GRAD_TOL)
    # identically zero at a batch of one, as in the reference
    assert ntxent_loss(ts[:1], torch.from_numpy(t[:1])).item() == 0.0


def test_kernel_args_reject_what_the_kernels_do_not_take():
    n, v, d = 4, 10, 896
    h = torch.zeros(n, d, dtype=torch.bfloat16)
    w = torch.zeros(v, d, dtype=torch.bfloat16)
    t = torch.zeros(n, v)
    with pytest.raises(ValueError, match="model dim"):
        fkl.kernel_args(h[:, :64].contiguous(), w[:, :64].contiguous(), t)
    with pytest.raises(ValueError, match="bfloat16"):
        fkl.kernel_args(h.float(), w, t)
    with pytest.raises(ValueError, match="contiguous"):
        fkl.kernel_args(h, w.T.contiguous().T, t)
    with pytest.raises(ValueError, match="tmat"):
        fkl.kernel_args(h, w, t[:, :9].contiguous())
    with pytest.raises(ValueError, match="tmat"):
        fkl.kernel_args(h, w, t.to(torch.bfloat16))
    with pytest.raises(ValueError, match="CUDA"):
        fkl.kernel_args(h, w, t)
    with pytest.raises(ValueError, match="truncated"):
        fkl.fused_kl_loss(h, w, t[:, :9], temperature=0.8)
