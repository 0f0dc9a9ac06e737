"""The port's combined LoCa + CE (K11's plain versions, ``ops/fused_loca.py``)
on the CPU against the JAX package's ``fused_loca_ce_loss`` with
``teacher_logits="materialize"`` and the "vd" head, run as its own tests run
it (Pallas in interpret mode), at the shapes of
``tests/test_fused_loca_ce.py``; and the port's ``loca_loss`` against the
JAX package's on dense logits.

The JAX call takes the teacher's (hidden, head); the port takes the teacher
logits built from the same arrays, ``ht @ wt[:, :V] / T`` in float32.
Tolerances are those of ``tests/test_fused_loca_ce.py``: values rtol 2e-5 /
atol 1e-6, gradients rtol 2e-4 / atol 2e-6 (both sides f32, summation order
only)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.losses.kd_losses import (
    loca_calibrated_probs as jax_loca_calibrated_probs,
    loca_loss as jax_loca_loss,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.ops.fused_loca import (
    fused_loca_ce_loss as jax_fused_loca_ce_loss,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.losses import (
    loca_calibrated_probs,
    loca_loss,
    masked_cross_entropy,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops import (
    fused_loca as fl,
)

VALUE_TOL = dict(rtol=2e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-4, atol=2e-6)
GAMMA = 0.8


def _arrays(n, ds, dt, v, vt, seed, dup_max=False):
    rng = np.random.default_rng(seed)
    hs = rng.normal(size=(n, ds)).astype(np.float32)
    ht = rng.normal(size=(n, dt)).astype(np.float32)
    ws = rng.normal(size=(ds, v)).astype(np.float32) * 0.05
    wt = rng.normal(size=(dt, vt)).astype(np.float32) * 0.05
    if dup_max:
        # columns 5 and 7 identical and dominant: every row's teacher top-2
        # is an exact tie (tests/test_fused_loca.py's case)
        wt[:, 5] = np.abs(wt[:, 5]) + 0.5
        wt[:, 7] = wt[:, 5]
        ht = np.abs(ht)
    loca_labels = rng.integers(0, v, size=(n,)).astype(np.int32)
    loca_labels[:7] = -100
    ce_labels = rng.integers(0, v, size=(n,)).astype(np.int32)
    ce_labels[-9:] = -100
    return hs, ht, ws, wt, loca_labels, ce_labels


def _jax(hs, ht, ws, wt, loca_labels, ce_labels, temp, alpha):
    """(loss, loca, ce, d hs, d ws [V, D]) of the JAX pipeline, "vd" head."""
    def f(h, w):
        loca, ce = jax_fused_loca_ce_loss(
            h, w, jnp.asarray(ht), jnp.asarray(wt), jnp.asarray(loca_labels),
            jnp.asarray(ce_labels), temperature=temp, alpha=alpha,
            student_head_layout="vd", teacher_logits="materialize")
        return GAMMA * loca + ce, (loca, ce)

    with pltpu.force_tpu_interpret_mode():
        (loss, (loca, ce)), (gh, gw) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            jnp.asarray(hs), jnp.asarray(ws.T))
    return float(loss), float(loca), float(ce), np.asarray(gh), np.asarray(gw)


def _port(hs, ht, ws, wt, loca_labels, ce_labels, temp, alpha):
    th = torch.tensor(hs, requires_grad=True)
    tw = torch.tensor(np.ascontiguousarray(ws.T), requires_grad=True)
    tmat = torch.from_numpy(ht @ wt[:, :ws.shape[1]]) / temp
    loca, ce = fl.fused_loca_ce_loss(th, tw, tmat, torch.from_numpy(loca_labels),
                                     torch.from_numpy(ce_labels), temperature=temp, alpha=alpha)
    loss = GAMMA * loca + ce
    gh, gw = torch.autograd.grad(loss, (th, tw))
    return loss.item(), loca.item(), ce.item(), gh.numpy(), gw.numpy()


@pytest.mark.parametrize("n,ds,dt,v,vt,temp,alpha", [
    (64, 128, 256, 300, 340, 0.8, 0.8),   # double-trouble preset, teacher vocab + 40
    (50, 96, 96, 513, 513, 1.0, 0.8),     # logit_based preset (T=1)
])
def test_plain_k11_matches_the_jax_kernels(n, ds, dt, v, vt, temp, alpha):
    arrays = _arrays(n, ds, dt, v, vt, seed=1)
    want = _jax(*arrays, temp, alpha)
    got = _port(*arrays, temp, alpha)
    for i, name in enumerate(("loss", "loca", "ce")):
        np.testing.assert_allclose(got[i], want[i], err_msg=name, **VALUE_TOL)
    np.testing.assert_allclose(got[3], want[3], err_msg="d hs", **GRAD_TOL)
    np.testing.assert_allclose(got[4], want[4], err_msg="d ws", **GRAD_TOL)


def test_duplicate_teacher_max():
    """A tied teacher maximum gives p_2nd = p_max (torch.topk(2)), in the
    plain K11 as in the JAX kernels and in dense loca_loss + masked CE."""
    n, ds, dt, v, temp, alpha = 16, 64, 64, 300, 1.0, 0.8
    hs, ht, ws, wt, loca_labels, ce_labels = _arrays(n, ds, dt, v, v, seed=3, dup_max=True)
    want = _jax(hs, ht, ws, wt, loca_labels, ce_labels, temp, alpha)
    got = _port(hs, ht, ws, wt, loca_labels, ce_labels, temp, alpha)
    for i, name in enumerate(("loss", "loca", "ce")):
        np.testing.assert_allclose(got[i], want[i], err_msg=name, **VALUE_TOL)
    np.testing.assert_allclose(got[3], want[3], err_msg="d hs", **GRAD_TOL)

    th = torch.tensor(hs, requires_grad=True)
    s_logits = (th @ torch.from_numpy(ws))[None]
    t_logits = torch.from_numpy(ht @ wt)[None]
    dense_loca = loca_loss(t_logits, s_logits, torch.from_numpy(loca_labels)[None].long(),
                           temperature=temp, alpha=alpha)
    # masked_cross_entropy shifts by one: feed the CE labels one step later
    shifted = torch.from_numpy(np.concatenate([[-100], ce_labels]))[None].long()
    dense_ce = masked_cross_entropy(torch.cat([s_logits, s_logits[:, :1]], dim=1), shifted)
    np.testing.assert_allclose(dense_loca.item(), got[1], rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(dense_ce.item(), got[2], **VALUE_TOL)
    (gh,) = torch.autograd.grad(GAMMA * dense_loca + dense_ce, (th,))
    np.testing.assert_allclose(gh.numpy(), got[3], **GRAD_TOL)


@pytest.mark.parametrize("temp", [0.8, 1.0])
def test_loca_loss_matches_jax(temp):
    rng = np.random.default_rng(5)
    t = rng.normal(size=(2, 7, 40)).astype(np.float32) * 3
    t[0, 2, 4] = t[0, 2, 9] = t[0, 2].max() + 1.0  # a tied maximum
    s = rng.normal(size=(2, 7, 33)).astype(np.float32)  # teacher vocab + 7: truncated
    labels = rng.integers(0, 33, size=(2, 7)).astype(np.int32)
    labels[1, :3] = -100
    want = float(jax_loca_loss(jnp.asarray(t), jnp.asarray(s), jnp.asarray(labels),
                               temperature=temp, alpha=0.8))
    got = loca_loss(torch.from_numpy(t), torch.from_numpy(s), torch.from_numpy(labels).long(),
                    temperature=temp, alpha=0.8).item()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-8)
    p = torch.softmax(torch.from_numpy(t[..., :33]), -1)
    np.testing.assert_allclose(
        loca_calibrated_probs(p, torch.from_numpy(labels).long(), 0.8).numpy(),
        np.asarray(jax_loca_calibrated_probs(jnp.asarray(p.numpy()), jnp.asarray(labels), 0.8)),
        rtol=1e-5, atol=1e-7)


def test_faithful_indexing_is_not_ported():
    p = torch.softmax(torch.zeros(1, 2, 5), -1)
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        loca_calibrated_probs(p, torch.zeros(1, 2, dtype=torch.long), 0.8, faithful_indexing=True)


def test_kernel_args_reject_what_the_kernels_do_not_take():
    n, v, d = 4, 10, 896
    h = torch.zeros(n, d, dtype=torch.bfloat16)
    w = torch.zeros(v, d, dtype=torch.bfloat16)
    t = torch.zeros(n, v)
    lab = torch.zeros(n, dtype=torch.int32)
    with pytest.raises(ValueError, match="model dim"):
        fl.kernel_args(h[:, :64].contiguous(), w[:, :64].contiguous(), t, lab, lab)
    with pytest.raises(ValueError, match="bfloat16"):
        fl.kernel_args(h.float(), w, t, lab, lab)
    with pytest.raises(ValueError, match="tmat"):
        fl.kernel_args(h, w, t[:, :9].contiguous(), lab, lab)
    with pytest.raises(ValueError, match="tmat"):
        fl.kernel_args(h, w, t.double(), lab, lab)
    with pytest.raises(ValueError, match="int32"):
        fl.kernel_args(h, w, t, lab.long(), lab)
    with pytest.raises(ValueError, match="CUDA"):
        fl.kernel_args(h, w, t, lab, lab)
    with pytest.raises(ValueError, match="truncated"):
        fl.fused_loca_ce_loss(h, w, t[:, :9], lab, lab, temperature=1.0, alpha=0.8)
