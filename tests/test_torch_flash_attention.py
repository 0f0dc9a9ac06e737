"""The port's attention ops on the CPU: the plain flash versions against the
JAX package's Pallas flash kernels (interpret mode, as
tests/test_flash_attention.py runs them), the plain attention paths against
the JAX XLA paths, the empty-row rule, and the kernel wrapper's checks.

Tolerance: atol 2e-5 in float32 (the JAX interpret-mode flash matched its
XLA reference to ~2e-6 on these cases)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.ops import (
    attention as jax_attention,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.ops import (
    flash_attention as jax_flash,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops import (
    attention,
    flash_attention as fa,
)

ATOL = 2e-5


def _mk(b, sq, skv, hq, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, hq, d)).astype(np.float32),
            rng.normal(size=(b, skv, hkv, d)).astype(np.float32),
            rng.normal(size=(b, skv, hkv, d)).astype(np.float32))


def _kv_mask(b, skv, n_valid):
    m = np.zeros((b, skv), dtype=bool)
    m[:, :n_valid] = True
    return m


def _torch(*xs):
    return [None if x is None else torch.from_numpy(x) for x in xs]


@pytest.fixture(autouse=True)
def zero_counts():
    fa.reset_launch_counts()
    yield
    # the plain (CPU) path never counts a launch
    assert fa.flash_attention.launches == 0
    assert fa.flash_attention_gqa.launches == 0


# (b, sq, skv, hq, hkv, d, causal, n_valid): the SigLIP case (MHA, d=72,
# non-causal) and the Qwen2 prefill case (GQA 7q/1kv, d=64, causal, kv mask)
CASES = {
    "mha_d72": (2, 200, 200, 2, 2, 72, False, None),
    "gqa_d64_causal_mask": (1, 160, 192, 7, 1, 64, True, 150),
}


@pytest.mark.parametrize("entry", ["flash_attention", "flash_attention_gqa"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_flash_matches_jax_interpret(case, entry):
    b, sq, skv, hq, hkv, d, causal, n_valid = CASES[case]
    q, k, v = _mk(b, sq, skv, hq, hkv, d)
    mask = None if n_valid is None else _kv_mask(b, skv, n_valid)
    with pltpu.force_tpu_interpret_mode():
        want = jax_flash.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            mask=None if mask is None else jnp.asarray(mask), causal=causal)
    got = getattr(fa, entry)(*_torch(q, k, v), mask=_torch(mask)[0], causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_mask_forms_agree():
    q, k, v = _torch(*_mk(2, 40, 50, 4, 2, 64, seed=1))
    m = torch.from_numpy(_kv_mask(2, 50, 33))
    a = fa.flash_attention(q, k, v, mask=m, causal=True)
    b = fa.flash_attention(q, k, v, mask=m[:, None, None, :], causal=True)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    with pytest.raises(ValueError, match="kv-padding"):
        fa.flash_attention(q, k, v, mask=torch.ones(2, 1, 40, 50, dtype=torch.bool))


def test_rows_without_a_valid_key_are_zero():
    q, k, v = _torch(*_mk(2, 70, 70, 2, 1, 64, seed=2))
    m = torch.ones(2, 70, dtype=torch.bool)
    m[0] = False              # sample 0: no valid key at all
    m[1, :5] = False          # sample 1, causal: rows 0..4 see no valid key
    out = fa.flash_attention(q, k, v, mask=m, causal=True)
    assert torch.isfinite(out).all()
    assert (out[0] == 0).all()
    assert (out[1, :5] == 0).all()
    # row 5 sees exactly one valid key (5): its output is that key's value
    torch.testing.assert_close(out[1, 5], v[1, 5, 0].expand(2, 64), atol=1e-6, rtol=0)


def test_causal_is_top_left_aligned():
    """Row i attends keys 0..i even when Skv > Sq (prefill over the whole
    fresh cache)."""
    q, k, v = _torch(*_mk(1, 8, 12, 1, 1, 64, seed=3))
    out = fa.flash_attention(q, k, v, causal=True)
    full = fa.flash_attention(q[:, :3], k[:, :3], v[:, :3])
    torch.testing.assert_close(out[:, 2], full[:, 2], atol=1e-6, rtol=0)


@pytest.mark.parametrize("causal,masked", [(False, False), (True, True), (True, False)])
def test_plain_attention_matches_jax_xla(causal, masked):
    """impl='xla': bottom-right causality and the JAX all-masked-row rule
    (uniform), including a sample whose rows are all masked."""
    q, k, v = _mk(2, 24, 40, 4, 2, 64, seed=4)
    mask = None
    if masked:
        m = _kv_mask(2, 40, 30)
        m[1] = False
        mask = m[:, None, None, :]
    want = jax_attention.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=None if mask is None else jnp.asarray(mask), causal=causal)
    got = attention.dot_product_attention(*_torch(q, k, v), mask=_torch(mask)[0], causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_gqa_decode_attention_matches_jax():
    q, k, v = _mk(2, 1, 33, 14, 2, 64, seed=5)
    m = (np.arange(33)[None, None, :] <= np.array([20, 32])[:, None, None])[:, None]
    want = jax_attention.gqa_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(m))
    got = attention.gqa_decode_attention(*_torch(q, k, v), mask=torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_flash_arm_on_cpu_is_the_plain_flash():
    q, k, v = _torch(*_mk(1, 130, 130, 2, 2, 72, seed=6))
    got = attention.dot_product_attention(q, k, v, impl="flash")
    torch.testing.assert_close(got, fa.flash_attention_ref(q, k, v), atol=0, rtol=0)
    # the JAX names of the kernel arm run the same kernels ("pallas_spmd": on
    # a rank's local tensors)
    for impl in ("pallas", "pallas_spmd"):
        torch.testing.assert_close(attention.dot_product_attention(q, k, v, impl=impl), got, atol=0, rtol=0)
    with pytest.raises(ValueError, match="unknown attention impl"):
        attention.dot_product_attention(q, k, v, impl="splash")


def _bf16(b=1, sq=64, skv=64, hq=2, hkv=2, d=64):
    return [torch.zeros(shape, dtype=torch.bfloat16)
            for shape in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d))]


@pytest.mark.parametrize("bad,match", [
    ("dtype", "bfloat16"),
    ("head_dim", "head dim"),
    ("heads", "multiple of kv heads"),
    ("contiguous", "contiguous"),
    ("mask", "kv_mask"),
])
def test_kernel_args_reject(bad, match):
    q, k, v = _bf16()
    mask = None
    if bad == "dtype":
        q = q.float()
    elif bad == "head_dim":
        q, k, v = _bf16(d=48)
    elif bad == "heads":
        q, k, v = _bf16(hq=3, hkv=2)
    elif bad == "contiguous":
        k = torch.zeros(1, 64, 64, 2, dtype=torch.bfloat16).transpose(2, 3)
    elif bad == "mask":
        mask = torch.ones(1, 63, dtype=torch.bool)
    with pytest.raises(ValueError, match=match):
        fa.kernel_args(q, k, v, mask)


def test_kernel_args_accept_slice_shapes():
    q, k, v = _bf16(b=1, sq=96, skv=100, hq=14, hkv=2, d=64)
    m = fa.kernel_args(q, k, v, torch.ones(1, 100, dtype=torch.bool))
    assert m.dtype == torch.uint8 and m.shape == (1, 100)
    assert fa.kernel_args(*_bf16(d=72), None) is None


def test_head_dims_give_tma_strides():
    """The kernels load q, k, v and dO by TMA (D = 64 backward, D = 72):
    every row stride H x D x 2 bytes and every head's offset D x 2 bytes
    must be a multiple of 16 for each head dim the kernels take."""
    for d in fa.KERNEL_HEAD_DIMS:
        assert d * 2 % 16 == 0, d


def _unaligned(shape):
    """A zero bf16 tensor of ``shape`` whose data starts 2 bytes past a
    16-byte boundary."""
    n = int(np.prod(shape))
    base = torch.zeros(n + 8, dtype=torch.bfloat16)
    t = base[1:1 + n].view(shape)
    assert t.data_ptr() % 16 == 2
    return t


@pytest.mark.parametrize("d", fa.KERNEL_HEAD_DIMS)
def test_launchers_refuse_unaligned_operands(d):
    """The launchers check 16-byte alignment before they load the library
    (TMA and the kernels' vector loads need it), so the check runs here."""
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops import _build

    q, k, v = _bf16(d=d)
    bad = _unaligned(q.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        _build.flash_fwd(bad, k, v, None, torch.empty_like(q), None, False, d**-0.5)
    if d in fa.BWD_HEAD_DIMS:
        lse = torch.zeros(q.shape[0], q.shape[2], q.shape[1])
        with pytest.raises(ValueError, match="16-byte aligned"):
            _build.flash_bwd(q, k, v, None, bad, lse, lse, torch.empty_like(q), torch.empty_like(k),
                             torch.empty_like(v), False, d**-0.5)


def test_non_cpu_non_cuda_tensor_raises():
    q, k, v = [t.to("meta") for t in _bf16()]
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, k, v)
