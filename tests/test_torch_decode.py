"""The port's greedy ``Generator`` against the JAX package's ``Generator`` on
the same converted params and synthetic batch (tiny config, float32, CPU).

Tokens, lengths and finished flags must be identical (the port adds each
step's top-2 margin); prefill logits agree
to atol 1e-4.  S = 128, so the port's "flash" arm takes the flash prefill
branch (through the plain flash version on the CPU) — the branch the card
takes.  Repetition penalty and the n=2 ban are on."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.configs import (
    llava_onevision_tiny,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.eval import (
    decode as jax_decode,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.models import (
    LlavaOnevision as FlaxLlava,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.utils.synthetic import (
    synthetic_kd_batch,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.configs import (
    llava_onevision_tiny as port_llava_onevision_tiny,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.eval import (
    decode,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.models import (
    LlavaOnevision,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.models.convert import (
    params_from_flax,
)

CFG = llava_onevision_tiny()
PCFG = port_llava_onevision_tiny()  # the port's own copy of the preset
N_NEW = 6
KEYS = ("student_input_ids", "student_attention_mask", "student_pixel_values",
        "pack_idx", "pack_weight", "pack_valid", "tile_valid")
OUT_KEYS = ("sequences", "valid", "lengths", "prompt_lengths", "finished", "tokens")


@pytest.fixture(scope="module")
def setup():
    batch = synthetic_kd_batch(CFG, batch_size=2, seq_len=128,
                               orig_sizes=[(45, 67), (30, 80)], seed=11)
    batch = {k: batch[k] for k in KEYS}
    batch["student_attention_mask"][1, 100:] = 0  # right padding: lengths differ
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = FlaxLlava(CFG).init(
        jax.random.PRNGKey(0),
        input_ids=jb["student_input_ids"],
        attention_mask=jb["student_attention_mask"],
        pixel_values=jb["student_pixel_values"],
        **{k: jb[k] for k in KEYS[3:]},
    )["params"]
    sd = params_from_flax(params, PCFG)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    return params, sd, jb, tb


def _jax_generate(params, jb, gcfg):
    gen = jax_decode.Generator(FlaxLlava(CFG), CFG, gcfg)
    return {k: np.asarray(v) for k, v in gen.generate(params, jb).items()}


def _port(sd, attn_impl):
    model = LlavaOnevision(PCFG, attn_impl=attn_impl)
    model.load_state_dict(sd)
    return model.eval()


@pytest.fixture(scope="module")
def jax_runs(setup):
    """JAX outputs without eos, and with eos set to the 3rd token sample 0
    emits, so that sample finishes early."""
    params, _, jb, _ = setup
    base = jax_decode.GenerateConfig(max_new_tokens=N_NEW, repetition_penalty=1.2,
                                     no_repeat_ngram_size=2, eos_token_id=-1)
    no_eos = _jax_generate(params, jb, base)
    eos = int(no_eos["tokens"][0, 2])
    with_eos = _jax_generate(params, jb, dataclasses.replace(base, eos_token_id=eos))
    assert with_eos["finished"][0]
    return {-1: no_eos, eos: with_eos}


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("which", ["no_eos", "eos"])
def test_generator_matches_jax(setup, jax_runs, attn_impl, which):
    _, sd, _, tb = setup
    eos = sorted(jax_runs)[0 if which == "no_eos" else 1]
    want = jax_runs[eos]
    gcfg = decode.GenerateConfig(max_new_tokens=N_NEW, repetition_penalty=1.2,
                                 no_repeat_ngram_size=2, eos_token_id=eos)
    got = decode.Generator(PCFG, gcfg).generate(_port(sd, attn_impl), tb)
    # the JAX outputs, and the port's top-2 margin of each step's processed logits
    assert set(got) == set(OUT_KEYS) | {"margins"}
    for k in OUT_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert got["margins"].shape == got["tokens"].shape and bool((got["margins"] >= 0).all())


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_prefill_logits_match_jax(setup, attn_impl):
    params, sd, jb, tb = setup
    b, s = jb["student_input_ids"].shape
    total = s + N_NEW
    lengths = jb["student_attention_mask"].sum(axis=1)
    q_pos = jnp.arange(s)[None, :, None]
    k_pos = jnp.arange(total)[None, None, :]
    prefill_mask = (k_pos <= q_pos) & (k_pos < lengths[:, None, None])
    caches = jax_decode.Generator(FlaxLlava(CFG), CFG)._init_caches(b, total, jnp.float32)
    want, _, _ = FlaxLlava(CFG).apply(
        {"params": params}, input_ids=jb["student_input_ids"],
        pixel_values=jb["student_pixel_values"], **{k: jb[k] for k in KEYS[3:]},
        positions=jnp.broadcast_to(jnp.arange(s)[None], (b, s)), caches=caches,
        cache_index=jnp.int32(0), decode_mask=prefill_mask[:, None])
    gen = decode.Generator(PCFG, decode.GenerateConfig(max_new_tokens=N_NEW))
    with torch.no_grad():
        got, caches, got_lengths = gen.prefill(_port(sd, attn_impl), tb)
    np.testing.assert_array_equal(got_lengths.numpy(), np.asarray(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    assert len(caches) == PCFG.text.num_hidden_layers
    assert caches[0]["k"].shape == (b, total, PCFG.text.num_key_value_heads, PCFG.text.head_dim)


def test_ngram_ban_and_presence_match_jax():
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 6, size=(3, 20)).astype(np.int32)  # many duplicates
    valid = rng.random((3, 20)) > 0.2
    for n in (2, 3):
        prefix = ids[:, -(n - 1):]
        want = jax_decode._ngram_ban_mask(jnp.asarray(ids), jnp.asarray(valid),
                                          jnp.asarray(prefix), 8)
        got = decode._ngram_ban_mask(*(torch.from_numpy(x) for x in (ids, valid, prefix)), 8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    logits = rng.normal(size=(3, 8)).astype(np.float32)
    presence = rng.random((3, 8)) > 0.5
    np.testing.assert_allclose(
        decode._apply_repetition_penalty(torch.from_numpy(logits), torch.from_numpy(presence), 1.2),
        np.asarray(jax_decode._apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(presence), 1.2)),
        rtol=0, atol=0)


def test_scatter_or_keeps_duplicate_trues():
    table = torch.zeros(1, 4, dtype=torch.bool)
    idx = torch.tensor([[2, 2, 2, 1]])
    src = torch.tensor([[False, True, False, False]])
    assert decode._scatter_or(table, idx, src).tolist() == [[False, False, True, False]]


@pytest.mark.parametrize("kwargs", [dict(no_repeat_ngram_size=1), dict(max_new_tokens=0)])
def test_generate_config_checks(kwargs):
    with pytest.raises(ValueError):
        decode.GenerateConfig(**kwargs)
