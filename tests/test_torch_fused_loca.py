"""The port's LoCa without CE (K9's plain versions, ``ops/fused_loca.py``:
``fused_loca_loss`` / ``fused_loca_sum`` over ``loca_rows_ref`` and
``loca_rows_bwd_ref``) on the CPU against the JAX package's
``fused_loca_loss``, run as ``tests/test_fused_loca.py`` runs it (Pallas in
interpret mode), at that file's shapes, with a duplicated teacher maximum
and ignored labels.

The JAX call takes the teacher's (hidden, head) and the student head
[D, V]; the port takes the teacher logits built in float32 from the same
arrays, ``ht @ wt[:, :V] / T``, and the head in its stored [V, D] layout
(transposed here only).  Values and the gradients in the hidden states and
the head: atol 1e-5, rtol 1e-4.  The plain K9 is also the plain K11's LoCa
part: its KL rows and row statistics (lse_s1 aside), and its backward
against K11's with the CE cotangent 0."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.ops.fused_loca import (
    fused_loca_loss as jax_fused_loca_loss,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.losses import (
    loca_loss,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops import (
    fused_loca as fl,
)

TOL = dict(atol=1e-5, rtol=1e-4)


def _arrays(n, ds, dt, v, vt, seed, dup_max=False):
    """tests/test_fused_loca.py's inputs: the first 7 labels ignored; with
    ``dup_max`` columns 5 and 7 identical and dominant, so every row's
    teacher top-2 is an exact tie inside the first vocab block."""
    rng = np.random.default_rng(seed)
    hs = rng.normal(size=(n, ds)).astype(np.float32)
    ht = rng.normal(size=(n, dt)).astype(np.float32)
    ws = rng.normal(size=(ds, v)).astype(np.float32) * 0.05
    wt = rng.normal(size=(dt, vt)).astype(np.float32) * 0.05
    if dup_max:
        wt[:, 5] = np.abs(wt[:, 5]) + 0.5
        wt[:, 7] = wt[:, 5]
        ht = np.abs(ht)
    labels = rng.integers(0, v, size=(n,)).astype(np.int32)
    labels[:7] = -100
    return hs, ht, ws, wt, labels


def _jax(hs, ht, ws, wt, labels, temp, alpha):
    """(loss, d hs, d ws [D, V]) of the JAX kernels in interpret mode."""
    def f(h, w):
        return jax_fused_loca_loss(h, w, jnp.asarray(ht), jnp.asarray(wt), jnp.asarray(labels),
                                   temperature=temp, alpha=alpha)

    with pltpu.force_tpu_interpret_mode():
        loss, (gh, gw) = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(hs), jnp.asarray(ws))
    return float(loss), np.asarray(gh), np.asarray(gw)


def _tmat(ht, wt, v, temp):
    return torch.from_numpy(ht @ wt[:, :v]) / temp


def _port(hs, ht, ws, wt, labels, temp, alpha):
    """(loss, d hs, d ws back in the JAX [D, V] layout) of the port."""
    th = torch.tensor(hs, requires_grad=True)
    tw = torch.tensor(np.ascontiguousarray(ws.T), requires_grad=True)
    loss = fl.fused_loca_loss(th, tw, _tmat(ht, wt, ws.shape[1], temp), torch.from_numpy(labels),
                              temperature=temp, alpha=alpha)
    gh, gw = torch.autograd.grad(loss, (th, tw))
    return loss.item(), gh.numpy(), gw.numpy().T


def _check(got, want):
    np.testing.assert_allclose(got[0], want[0], err_msg="loss", **TOL)
    np.testing.assert_allclose(got[1], want[1], err_msg="d hs", **TOL)
    np.testing.assert_allclose(got[2], want[2], err_msg="d head", **TOL)


@pytest.mark.parametrize("n,ds,dt,v,vt,temp,alpha", [
    (64, 128, 256, 300, 340, 1.0, 0.8),   # teacher vocab + 40: truncated
    (50, 96, 96, 513, 513, 0.8, 0.8),     # the double-trouble temperature
])
def test_plain_k9_matches_the_jax_kernels(n, ds, dt, v, vt, temp, alpha):
    arrays = _arrays(n, ds, dt, v, vt, seed=0)
    _check(_port(*arrays, temp, alpha), _jax(*arrays, temp, alpha))


@pytest.mark.parametrize("temp", [1.0, 0.8])
def test_duplicate_teacher_max(temp):
    """A tied teacher maximum gives p_2nd = p_max, in the plain K9 as in the
    JAX kernels and in dense ``loca_loss``."""
    n, ds, dt, v = 16, 64, 64, 300
    hs, ht, ws, wt, labels = _arrays(n, ds, dt, v, v, seed=3, dup_max=True)
    got = _port(hs, ht, ws, wt, labels, temp, 0.8)
    _check(got, _jax(hs, ht, ws, wt, labels, temp, 0.8))
    th = torch.tensor(hs, requires_grad=True)
    dense = loca_loss(torch.from_numpy(ht @ wt)[None], (th @ torch.from_numpy(ws))[None],
                      torch.from_numpy(labels)[None].long(), temperature=temp, alpha=0.8)
    (gh,) = torch.autograd.grad(dense, (th,))
    np.testing.assert_allclose(dense.item(), got[0], **TOL)
    np.testing.assert_allclose(gh.numpy(), got[1], **TOL)


def test_fused_loca_sum_is_the_unreduced_loss():
    n, ds, dt, v, temp = 40, 32, 48, 200, 0.8
    hs, ht, ws, wt, labels = _arrays(n, ds, dt, v, v, seed=5)
    args = (torch.from_numpy(hs), torch.from_numpy(np.ascontiguousarray(ws.T)), _tmat(ht, wt, v, temp),
            torch.from_numpy(labels))
    total = fl.fused_loca_sum(*args, temperature=temp, alpha=0.8)
    loss = fl.fused_loca_loss(*args, temperature=temp, alpha=0.8)
    np.testing.assert_allclose(loss.item(), total.item() / (n * v) * temp**2, rtol=1e-6)


def test_plain_k9_is_the_loca_part_of_plain_k11():
    """Forward: K9's KL rows and row statistics are K11's (lse_s1, which K9
    leaves at 0, aside).  Backward: K9's dh and dW from the KL rows'
    cotangent are K11's with the CE cotangent 0, and without dW the same
    dh."""
    n, ds, dt, v, temp = 48, 64, 64, 300, 0.8
    hs, ht, ws, wt, labels = _arrays(n, ds, dt, v, v, seed=7, dup_max=True)
    h, w = torch.from_numpy(hs), torch.from_numpy(np.ascontiguousarray(ws.T))
    tmat, lab = _tmat(ht, wt, v, temp), torch.from_numpy(np.where(labels < 0, -1, labels))
    lab_ce = torch.from_numpy(np.random.default_rng(8).integers(0, v, size=(n,)).astype(np.int32))
    kw = dict(inv_t=1.0 / temp, eps=1e-8)
    kl9, st9 = fl.loca_rows_ref(h, w, tmat, lab, alpha=0.8, chunk=16, **kw)
    kl11, _, st11 = fl.loca_ce_rows_ref(h, w, tmat, lab, lab_ce, alpha=0.8, chunk=16, **kw)
    s1 = fl.ROW_STATS.index("lse_s1")
    assert torch.equal(kl9, kl11)
    assert not st9[s1].any()
    keep = [i for i in range(len(fl.ROW_STATS)) if i != s1]
    assert torch.equal(st9[keep], st11[keep])
    g = torch.rand(n, generator=torch.Generator().manual_seed(9)) + 0.5
    dh9, dw9 = fl.loca_rows_bwd_ref(h, w, tmat, lab, st11, g, chunk=16, **kw)
    dh11, dw11 = fl.loca_ce_rows_bwd_ref(h, w, tmat, lab, lab_ce, st11, g, torch.zeros(n), chunk=16, **kw)
    np.testing.assert_allclose(dh9.numpy(), dh11.numpy(), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(dw9.numpy(), dw11.numpy(), rtol=1e-6, atol=1e-9)
    dh_only, no_dw = fl.loca_rows_bwd_ref(h, w, tmat, lab, st11, g, need_dw=False, chunk=16, **kw)
    assert no_dw is None and torch.equal(dh_only, dh9)


def test_k9_refuses_what_it_does_not_take():
    n, v, d = 4, 10, 896
    h = torch.zeros(n, d, dtype=torch.bfloat16)
    w = torch.zeros(v, d, dtype=torch.bfloat16)
    t = torch.zeros(n, v)
    lab = torch.zeros(n, dtype=torch.int32)
    with pytest.raises(ValueError, match="truncated"):
        fl.fused_loca_loss(h, w, t[:, :9], lab, temperature=1.0)
    with pytest.raises(ValueError, match="int32"):
        fl.kernel_args(h, w, t, lab.long())
    with pytest.raises(ValueError, match="CUDA"):
        fl.kernel_args(h, w, t, lab)
