"""The port's flash-attention backward on the CPU against the JAX package's
Pallas flash kernels (interpret mode, as tests/test_flash_attention.py runs
them): the plain backward from the saved lse (the plain version of the
K2/K4 kernels), the CPU autograd path, the lse itself, and the rule that a
row with no valid key has zero output and zero gradient.

Inputs come from a seeded numpy generator, in float32.  Tolerance: atol
2e-5 (both sides compute the same f32 math; measured differences ~1e-6)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.ops import (
    flash_attention as jax_flash,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops import (
    flash_attention as fa,
)

ATOL = 2e-5

# (b, s, hq, hkv, d, causal, n_valid): the SigLIP case (MHA, d=72,
# non-causal) and the Qwen2 training case (GQA 7 q heads per kv head, d=64,
# causal, kv padding mask)
CASES = {
    "mha_d72": (1, 100, 2, 2, 72, False, None),
    "gqa_d64_causal_mask": (1, 130, 14, 2, 64, True, 110),
}


def _inputs(b, s, hq, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, hq, d))]


def _mask(b, s, n_valid):
    if n_valid is None:
        return None
    m = np.zeros((b, s), dtype=bool)
    m[:, :n_valid] = True
    return m


def _jax_grads(q, k, v, dout, mask, causal):
    def f(q_, k_, v_):
        return jax_flash.flash_attention(q_, k_, v_, mask=None if mask is None else jnp.asarray(mask),
                                         causal=causal)

    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        grads = vjp(jnp.asarray(dout))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.fixture(autouse=True)
def zero_counts():
    fa.reset_launch_counts()
    yield
    assert all(fn.launches == 0 for fn in fa.WRAPPERS)  # the CPU path never counts


@pytest.fixture(scope="module")
def jax_results():
    out = {}
    for name, (b, s, hq, hkv, d, causal, n_valid) in CASES.items():
        q, k, v, dout = _inputs(b, s, hq, hkv, d)
        out[name] = _jax_grads(q, k, v, dout, _mask(b, s, n_valid), causal)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_from_lse_matches_jax(case, jax_results):
    b, s, hq, hkv, d, causal, n_valid = CASES[case]
    q, k, v, dout = map(torch.from_numpy, _inputs(b, s, hq, hkv, d))
    mask = _mask(b, s, n_valid)
    mask = None if mask is None else torch.from_numpy(mask)
    out, lse = fa.flash_attention_ref(q, k, v, mask, causal, return_lse=True)
    delta = fa.attention_delta(out, dout)
    bwd = fa.flash_attention_bwd if hq == hkv else fa.flash_attention_gqa_bwd
    got = bwd(q, k, v, dout, lse, delta, mask=mask, causal=causal)
    want_out, want = jax_results[case]
    np.testing.assert_allclose(out.numpy(), want_out, atol=ATOL, rtol=0)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_cpu_autograd_matches_jax(case, jax_results):
    b, s, hq, hkv, d, causal, n_valid = CASES[case]
    q, k, v, dout = (torch.from_numpy(x).requires_grad_(i < 3)
                     for i, x in enumerate(_inputs(b, s, hq, hkv, d)))
    mask = _mask(b, s, n_valid)
    out = fa.flash_attention(q, k, v, mask=None if mask is None else torch.from_numpy(mask),
                             causal=causal)
    out.backward(dout)
    _, want = jax_results[case]
    for name, g, w in zip(("dq", "dk", "dv"), (q.grad, k.grad, v.grad), want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0, err_msg=name)


def test_lse_is_the_row_logsumexp():
    q, k, v, _ = map(torch.from_numpy, _inputs(1, 40, 2, 1, 64, seed=1))
    mask = torch.from_numpy(_mask(1, 40, 30))
    _, lse = fa.flash_attention_ref(q, k, v, mask, True, scale=0.3, return_lse=True)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.expand(-1, -1, 2, -1)) * 0.3
    keep = (torch.arange(40)[:, None] >= torch.arange(40)[None, :]) & mask[0][None, :]
    want = torch.logsumexp(s.masked_fill(~keep, float("-inf")), dim=-1)
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=0)


def test_rows_without_a_valid_key_get_zero_gradients(jax_results):
    """Sample 0 has no valid key at all; in sample 1 (causal) rows 0..4 see
    only masked keys.  Their outputs and gradients are exactly 0, nothing is
    NaN, and the rest agrees with the JAX kernels."""
    b, s, hq, hkv, d = 2, 70, 2, 1, 64
    q, k, v, dout = _inputs(b, s, hq, hkv, d, seed=2)
    m = np.ones((b, s), dtype=bool)
    m[0] = False
    m[1, :5] = False
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    tm = torch.from_numpy(m)
    out, lse = fa.flash_attention_ref(tq, tk, tv, tm, True, return_lse=True)
    assert torch.isneginf(lse[0]).all() and torch.isneginf(lse[1, :, :5]).all()
    dq, dk, dv = fa.flash_attention_gqa_bwd(tq, tk, tv, tdo, lse, fa.attention_delta(out, tdo),
                                            mask=tm, causal=True)
    for t in (out, dq, dk, dv):
        assert torch.isfinite(t).all()
    assert (out[0] == 0).all() and (out[1, :5] == 0).all()
    assert (dq[0] == 0).all() and (dq[1, :5] == 0).all()
    assert (dk[0] == 0).all() and (dv[0] == 0).all()
    assert (dk[1, :5] == 0).all() and (dv[1, :5] == 0).all()  # masked keys
    # sample 1, rows 5.. against the JAX kernels
    _, want = _jax_grads(q[1:], k[1:], v[1:], dout[1:], m[1:], True)
    for g, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(g[1:].numpy(), w, atol=ATOL, rtol=0)


def test_neutralize_dead_rows():
    lse = torch.tensor([[[1.0, float("-inf"), -3.0]]])
    delta = torch.tensor([[[0.5, 7.0, -1.0]]])
    lse2, delta2 = fa.neutralize_dead_rows(lse, delta)
    assert lse2[0, 0, 1] > 1e38 and delta2[0, 0, 1] == 0
    assert torch.equal(lse2[..., [0, 2]], lse[..., [0, 2]])
    assert torch.equal(delta2[..., [0, 2]], delta[..., [0, 2]])


@pytest.mark.parametrize("q_shape,k_shape,want", [
    ((1, 3072, 14, 64), (1, 3072, 2, 64), (2, 7, 1, 3072, 2, 64)),  # the Qwen2 training shape
    ((2, 65, 2, 64), (2, 65, 2, 64), (2, 1, 2, 65, 2, 64)),          # MHA at D = 64: one head a group
    ((10, 729, 16, 72), (10, 729, 16, 72), None),                    # SigLIP's D = 72: no workspace
], ids=["gqa_d64", "mha_d64", "d72"])
def test_bwd_workspace_shape_routes_by_head_dim(q_shape, k_shape, want):
    assert fa.bwd_workspace_shape(q_shape, k_shape) == want


def test_per_head_partials_summed_in_order_match_jax(jax_results):
    """The D = 64 kernels' decomposition: each query head h writes its own
    dk/dv partial at part[:, h % G, b, :, h // G], and the kernel sums the G
    partials of a kv head in the order g = 0, 1, ...  Built here from the
    plain backward one query head at a time, in the workspace's layout, the
    sums are the JAX kernels' GQA dk and dv."""
    b, s, hq, hkv, d, causal, n_valid = CASES["gqa_d64_causal_mask"]
    q, k, v, dout = map(torch.from_numpy, _inputs(b, s, hq, hkv, d))
    mask = torch.from_numpy(_mask(b, s, n_valid))
    out, lse = fa.flash_attention_ref(q, k, v, mask, causal, return_lse=True)
    lse, delta = fa.neutralize_dead_rows(lse, fa.attention_delta(out, dout))
    group = hq // hkv
    part = torch.zeros(fa.bwd_workspace_shape(q.shape, k.shape))
    for h in range(hq):
        hk = h // group
        _, dk_h, dv_h = fa.flash_attention_bwd_ref(
            q[:, :, h:h + 1], k[:, :, hk:hk + 1], v[:, :, hk:hk + 1], mask, causal, d**-0.5,
            lse[:, h:h + 1], delta[:, h:h + 1], dout[:, :, h:h + 1])
        part[0, h % group, :, :, hk] = dk_h[:, :, 0]
        part[1, h % group, :, :, hk] = dv_h[:, :, 0]
    dk, dv = part[0, 0].clone(), part[1, 0].clone()
    for g in range(1, group):
        dk += part[0, g]
        dv += part[1, g]
    _, want = jax_results["gqa_d64_causal_mask"]
    np.testing.assert_allclose(dk.numpy(), want[1], atol=ATOL, rtol=0)
    np.testing.assert_allclose(dv.numpy(), want[2], atol=ATOL, rtol=0)
