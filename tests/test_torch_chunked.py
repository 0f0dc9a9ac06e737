"""The port's ``losses/chunked.py`` on the CPU against the JAX package's, as
``tests/test_chunked.py`` holds the JAX one, on the same numpy inputs,
float32.

The port takes the teacher as its logits ``tmat`` [B * S, V] at 1/T, built
here from the same (th, wt) as ``th @ wt[:, :V] / T``, and the student head
in its [V, D] layout (transposed here only); rows are the flattened [B, S]
positions, b-major.

* ``chunked_faithful_loca`` equals the JAX ``chunked_faithful_loca`` and the
  materialized ``loca_loss(faithful_indexing=True)``, in value (rtol 1e-5)
  and student gradients (rtol 1e-4), at chunk sizes that split the rows
  unevenly, with ties for the teacher's first and second places, with no
  valid label at all, and with an int8 teacher head (``tmat`` from K10's
  plain version against the JAX per-chunk dequantized head);
* ``chunked_kd_terms`` equals the JAX ``chunked_kd_terms`` (CE, KL and the
  paper-correct LoCa) in value and student gradients."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.losses import (
    loca_loss as jax_loca_loss,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.losses.chunked import (
    chunked_faithful_loca as jax_chunked_faithful_loca,
    chunked_kd_terms as jax_chunked_kd_terms,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.ops.int8 import (
    absmax_quantize_weight,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.losses.chunked import (
    chunked_faithful_loca,
    chunked_kd_terms,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.losses.kd_losses import (
    IGNORE_INDEX,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops.fused_loca import (
    materialize_teacher_logits_int8_ref,
)

B, S, DS, DT, VS, VT = 2, 13, 8, 12, 37, 41
T, ALPHA = 0.8, 0.8
VALUE_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _setup(seed, ties=False):
    rng = np.random.default_rng(seed)
    sh = rng.normal(size=(B, S, DS)).astype(np.float32)
    th = rng.normal(size=(B, S, DT)).astype(np.float32)
    ws = rng.normal(size=(DS, VS)).astype(np.float32)
    wt = rng.normal(size=(DT, VT)).astype(np.float32)
    if ties:
        # columns 3 and 8 equal and dominant (a tied maximum: the second-best
        # id is 8), columns 20 and 14 equal and second (their tie breaks to 14)
        th = np.abs(th)
        wt[:, 3] = np.abs(wt[:, 3]) + 1.0
        wt[:, 8] = wt[:, 3]
        wt[:, 20] = wt[:, 3] - 0.3
        wt[:, 14] = wt[:, 20]
    labels = rng.integers(0, VS, size=(B, S)).astype(np.int32)
    labels[0, :3] = -100
    labels[1, -2:] = -100
    return sh, th, ws, wt, labels


def _jax_value_and_grads(f, sh, ws):
    value, (gsh, gws) = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(sh), jnp.asarray(ws))
    return float(value), np.asarray(gsh), np.asarray(gws)


def _port_value_and_grads(f, sh, ws):
    """f(hidden [B*S, D], head [V, D]); grads back in the JAX layouts."""
    h = torch.tensor(sh.reshape(B * S, DS), requires_grad=True)
    w = torch.tensor(np.ascontiguousarray(ws.T), requires_grad=True)
    value = f(h, w)
    gh, gw = torch.autograd.grad(value, (h, w))
    return value.item(), gh.numpy().reshape(B, S, DS), gw.numpy().T


def _tmat(th, wt):
    return torch.from_numpy(th.reshape(B * S, DT) @ wt[:, :VS]) / T


def _check(got, want):
    np.testing.assert_allclose(got[0], want[0], **VALUE_TOL)
    np.testing.assert_allclose(got[1], want[1], err_msg="d hidden", **GRAD_TOL)
    np.testing.assert_allclose(got[2], want[2], err_msg="d head", **GRAD_TOL)


@pytest.mark.parametrize("chunk", [4, 5, 13, 32])
@pytest.mark.parametrize("seed,ties", [(0, False), (3, True)], ids=["seed0", "ties"])
def test_chunked_faithful_loca_matches_jax(seed, ties, chunk):
    sh, th, ws, wt, labels = _setup(seed, ties)
    tmat, lab = _tmat(th, wt), torch.from_numpy(labels.reshape(-1))

    def port(h, w):
        return chunked_faithful_loca(h, w, lab, tmat, temperature=T, alpha=ALPHA, chunk_size=chunk)

    got = _port_value_and_grads(port, sh, ws)
    _check(got, _jax_value_and_grads(
        lambda s_, w_: jax_chunked_faithful_loca(s_, w_, jnp.asarray(labels), jnp.asarray(th), jnp.asarray(wt),
                                                 temperature=T, alpha=ALPHA, chunk_size=chunk), sh, ws))
    # and the materialized faithful loca_loss of the JAX package
    _check(got, _jax_value_and_grads(
        lambda s_, w_: jax_loca_loss(jnp.asarray(th) @ jnp.asarray(wt), s_ @ w_, jnp.asarray(labels),
                                     temperature=T, alpha=ALPHA, faithful_indexing=True), sh, ws))


def test_chunked_faithful_loca_all_ignore_labels():
    """No valid label anywhere: no label column is written, chunked or not."""
    sh, th, ws, wt, labels = _setup(1)
    labels[:] = IGNORE_INDEX
    tmat, lab = _tmat(th, wt), torch.from_numpy(labels.reshape(-1))
    got = _port_value_and_grads(
        lambda h, w: chunked_faithful_loca(h, w, lab, tmat, temperature=T, alpha=ALPHA, chunk_size=5), sh, ws)
    want = _jax_value_and_grads(
        lambda s_, w_: jax_loca_loss(jnp.asarray(th) @ jnp.asarray(wt), s_ @ w_, jnp.asarray(labels),
                                     temperature=T, alpha=ALPHA, faithful_indexing=True), sh, ws)
    _check(got, want)


def test_chunked_faithful_loca_int8_head():
    """The int8 teacher head: the port's tmat from K10's plain version (the
    vocab-major int8 head and its scales), the JAX scan dequantizing it per
    chunk."""
    sh, th, ws, wt, labels = _setup(2)
    wq, wsc = absmax_quantize_weight(jnp.asarray(wt))  # [DT, VT] int8, [VT] scales
    wq_vd = np.ascontiguousarray(np.asarray(wq).T)
    tmat = materialize_teacher_logits_int8_ref(torch.from_numpy(th.reshape(B * S, DT)), torch.from_numpy(wq_vd),
                                               torch.from_numpy(np.asarray(wsc).reshape(-1)), 1.0 / T, VS)
    lab = torch.from_numpy(labels.reshape(-1))
    got = _port_value_and_grads(
        lambda h, w: chunked_faithful_loca(h, w, lab, tmat, temperature=T, alpha=ALPHA, chunk_size=5), sh, ws)
    want = _jax_value_and_grads(
        lambda s_, w_: jax_chunked_faithful_loca(s_, w_, jnp.asarray(labels), jnp.asarray(th),
                                                 (jnp.asarray(wq_vd), wsc), temperature=T, alpha=ALPHA,
                                                 chunk_size=5), sh, ws)
    _check(got, want)


@pytest.mark.parametrize("terms", [("ce",), ("kl",), ("loca",), ("ce", "kl", "loca")])
def test_chunked_kd_terms_match_jax(terms):
    sh, th, ws, wt, labels = _setup(4)
    need = {f"need_{k}": k in terms for k in ("ce", "kl", "loca")}
    tmat, lab = _tmat(th, wt), torch.from_numpy(labels.reshape(-1))
    shifted = np.concatenate([labels[:, 1:], np.full((B, 1), IGNORE_INDEX, np.int32)], axis=1)
    ce_lab = torch.from_numpy(shifted.reshape(-1))

    def port(h, w):
        out = chunked_kd_terms(h, w, lab, ce_lab, tmat, temperature=T, alpha=ALPHA, chunk_size=5, **need)
        assert set(out) == set(terms)
        return sum(out.values())

    def jax_f(s_, w_):
        out = jax_chunked_kd_terms(s_, w_, jnp.asarray(labels), jnp.asarray(th), jnp.asarray(wt),
                                   temperature=T, loca_alpha=ALPHA, chunk_size=5, **need)
        return sum(out.values())

    _check(_port_value_and_grads(port, sh, ws), _jax_value_and_grads(jax_f, sh, ws))


def test_chunked_terms_refuse_a_missing_teacher():
    h, w = torch.zeros(6, 4), torch.zeros(9, 4)
    lab = torch.zeros(6, dtype=torch.long)
    with pytest.raises(ValueError, match="tmat"):
        chunked_kd_terms(h, w, lab, lab, None, need_kl=True)
    with pytest.raises(ValueError, match="tmat"):
        chunked_faithful_loca(h, w, lab, torch.zeros(6, 8))
