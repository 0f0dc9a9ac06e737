"""The port's ``losses/kd_losses.py`` on the CPU against the JAX package's,
on the same numpy inputs, float32, rtol 1e-5: the faithful LoCa
(``loca_calibrated_probs`` / ``loca_loss`` with ``faithful_indexing=True``:
the reference's whole-column writes, last write wins, ties of the teacher's
top-2 broken to the lowest index as ``jax.lax.top_k`` breaks them, the
all-ignore quirk), OFA, feature MSE and the phase-1 vision loss; and the
faithful LoCa against a literal torch fancy-indexing replica of the
reference."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.losses import (
    kd_losses as jkd,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.losses import (
    kd_losses as pkd,
)

B, S, V_S, V_T = 2, 9, 40, 47
RTOL = dict(rtol=1e-5, atol=1e-7)


def _tensors(seed, ties=False):
    """(student logits, teacher logits [vocab + 7], labels with ignores);
    with ``ties`` the teacher's maximum is duplicated at some positions
    (columns 4 and 9) and its second place at others (columns 6 and 2)."""
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(B, S, V_S)).astype(np.float32)
    t = (rng.normal(size=(B, S, V_T)) * 3).astype(np.float32)
    if ties:
        top = t[..., :V_S].max(-1)
        t[0, :4, 4] = t[0, :4, 9] = top[0, :4] + 1.0
        t[1, 2:5, 6] = t[1, 2:5, 2] = top[1, 2:5] + 0.5
        t[1, 2:5, 11] = top[1, 2:5] + 2.0
    labels = rng.integers(0, V_S, size=(B, S)).astype(np.int32)
    labels[0, :2] = -100
    labels[1, -3:] = -100
    return s, t, labels


def _torch_fancy_faithful(teacher, student, labels, temperature, alpha):
    """The reference's full-tensor fancy-indexing LoCa, literally."""
    t = torch.tensor(teacher)[:, :, :student.shape[-1]]
    lab = torch.tensor(np.where(labels < 0, 0, labels), dtype=torch.long)
    p_t = F.softmax(t / temperature, dim=-1)
    p_s = torch.clamp(F.softmax(torch.tensor(student) / temperature, dim=-1), min=1e-8)
    gt = p_t.gather(2, lab.unsqueeze(-1)).squeeze(-1)
    k = torch.tensor(np.array(jax.lax.top_k(jnp.asarray(p_t.numpy()), 2)[1][..., 1])).long()
    p_k = p_t.gather(2, k.unsqueeze(-1)).squeeze(-1)
    sc = alpha / (1 - gt + p_k)
    loca = p_t.clone()
    loca[:, :, lab] = 1 - sc * (p_t.sum(dim=-1) - gt)
    loca[:, :, k] = sc * p_k
    return (F.kl_div(p_s.log(), loca, reduction="mean") * temperature**2).item()


@pytest.mark.parametrize("seed,ties", [(0, False), (1, True), (2, True)])
@pytest.mark.parametrize("temp", [0.8, 1.0])
def test_faithful_loca_loss_matches_jax(seed, ties, temp):
    s, t, labels = _tensors(seed, ties)
    want = float(jkd.loca_loss(jnp.asarray(t), jnp.asarray(s), jnp.asarray(labels), temp, alpha=0.8,
                               faithful_indexing=True))
    got = pkd.loca_loss(torch.from_numpy(t), torch.from_numpy(s), torch.from_numpy(labels).long(), temp,
                        alpha=0.8, faithful_indexing=True).item()
    np.testing.assert_allclose(got, want, **RTOL)
    np.testing.assert_allclose(got, _torch_fancy_faithful(t, s, labels, temp, 0.8), rtol=1e-5)


@pytest.mark.parametrize("seed,ties", [(0, False), (1, True)])
def test_faithful_calibrated_probs_match_jax(seed, ties):
    _, t, labels = _tensors(seed, ties)
    p = torch.softmax(torch.from_numpy(t[..., :V_S]) / 0.8, -1)
    got = pkd.loca_calibrated_probs(p, torch.from_numpy(labels).long(), 0.8, faithful_indexing=True)
    want = jkd.loca_calibrated_probs(jnp.asarray(p.numpy()), jnp.asarray(labels), 0.8, faithful_indexing=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RTOL)


def test_faithful_all_ignore_labels_write_no_label_column():
    """A batch without a valid label writes no label column (the ignored
    labels would write column 0 otherwise); the second-best writes stay."""
    _, t, labels = _tensors(4)  # no position's second-best is column 0
    labels[:] = -100
    p = torch.softmax(torch.from_numpy(t[..., :V_S]), -1)
    assert 0 not in pkd.second_best(p).reshape(-1).tolist()
    got = pkd.loca_calibrated_probs(p, torch.from_numpy(labels).long(), 0.8, faithful_indexing=True)
    want = jkd.loca_calibrated_probs(jnp.asarray(p.numpy()), jnp.asarray(labels), 0.8, faithful_indexing=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RTOL)
    assert torch.equal(got[..., 0], p[..., 0])
    one_valid = labels.copy()
    one_valid[0, 0] = 7
    written = pkd.loca_calibrated_probs(p, torch.from_numpy(one_valid).long(), 0.8, faithful_indexing=True)
    assert not torch.equal(written[..., 0], p[..., 0])  # one valid label: the ignored ones write column 0


def test_second_best_breaks_ties_as_jax_top_k():
    x = np.array([[1.0, 3.0, 3.0, 0.5], [2.0, 1.0, 1.0, 0.0], [0.0, 5.0, 1.0, 5.0],
                  [4.0, 4.0, 4.0, 1.0]], np.float32)
    want = np.asarray(jax.lax.top_k(jnp.asarray(x), 2)[1][:, 1])
    assert pkd.second_best(torch.from_numpy(x)).tolist() == want.tolist() == [2, 1, 3, 1]


@pytest.mark.parametrize("gamma", [1.0, 2.0])
def test_ofa_loss_matches_jax(gamma):
    s, t, _ = _tensors(4)
    want = float(jkd.ofa_loss(jnp.asarray(t[..., :V_S]), jnp.asarray(s), 0.8, gamma=gamma))
    got = pkd.ofa_loss(torch.from_numpy(t[..., :V_S]), torch.from_numpy(s), 0.8, gamma=gamma).item()
    np.testing.assert_allclose(got, want, **RTOL)


def test_feature_mse_loss_matches_jax():
    rng = np.random.default_rng(5)
    a, b = (rng.normal(size=(4, 16)).astype(np.float32) for _ in range(2))
    want = float(jkd.feature_mse_loss(jnp.asarray(a), jnp.asarray(b)))
    got = pkd.feature_mse_loss(torch.from_numpy(a), torch.from_numpy(b)).item()
    np.testing.assert_allclose(got, want, **RTOL)


def test_vision_phase1_loss_matches_jax():
    s, t, _ = _tensors(6)
    rng = np.random.default_rng(6)
    sf, tf = (rng.normal(size=(4, 16)).astype(np.float32) for _ in range(2))
    want = float(jkd.vision_phase1_loss(jnp.asarray(s), jnp.asarray(t), jnp.asarray(sf), jnp.asarray(tf), 0.8))
    got = pkd.vision_phase1_loss(torch.from_numpy(s), torch.from_numpy(t), torch.from_numpy(sf),
                                 torch.from_numpy(tf), 0.8).item()
    np.testing.assert_allclose(got, want, **RTOL)


def test_faithful_loca_gradient_matches_jax():
    s, t, labels = _tensors(7, ties=True)

    def jf(s_):
        return jkd.loca_loss(jnp.asarray(t), s_, jnp.asarray(labels), 0.8, faithful_indexing=True)

    want = np.asarray(jax.grad(jf)(jnp.asarray(s)))
    ts = torch.tensor(s, requires_grad=True)
    loss = pkd.loca_loss(torch.from_numpy(t), ts, torch.from_numpy(labels).long(), 0.8,
                         faithful_indexing=True)
    (got,) = torch.autograd.grad(loss, (ts,))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-8)
