"""The PyTorch port's models against the Flax modules of the JAX package on
the same converted params (tiny config, float32, CPU), and the port's HF
snapshot route against the HF model's own forward.

Tolerance: atol 1e-4 in float32 — both sides compute the same math in f32;
differences come from summation order only (measured ~1e-6)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.configs import (
    llava_onevision_tiny,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.models import (
    LlavaOnevision as FlaxLlava,
    Qwen2LM as FlaxQwen2LM,
    SigLIPVisionTower as FlaxSigLIP,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.utils.synthetic import (
    synthetic_kd_batch,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.configs import (
    llava_onevision_tiny as port_llava_onevision_tiny,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.models import (
    LlavaOnevision,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.models.convert import (
    load_llava_onevision_params,
    params_from_flax,
)

CFG = llava_onevision_tiny()
PCFG = port_llava_onevision_tiny()  # the port's own copy of the preset
ATOL = 1e-4
BATCH_KEYS = ("pixel_values", "pack_idx", "pack_weight", "pack_valid", "tile_valid")


@pytest.fixture(scope="module")
def batch():
    return synthetic_kd_batch(CFG, batch_size=2, seq_len=64, seed=5)


@pytest.fixture(scope="module")
def flax_params(batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return FlaxLlava(CFG).init(
        jax.random.PRNGKey(1),
        input_ids=jb["student_input_ids"],
        attention_mask=jb["student_attention_mask"],
        pixel_values=jb["student_pixel_values"],
        pack_idx=jb["pack_idx"],
        pack_weight=jb["pack_weight"],
        pack_valid=jb["pack_valid"],
        tile_valid=jb["tile_valid"],
    )["params"]


def _port_model(flax_params, attn_impl="xla"):
    model = LlavaOnevision(PCFG, attn_impl=attn_impl)
    model.load_state_dict(params_from_flax(flax_params, PCFG))
    return model.eval()


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


def test_state_dict_covers_every_param(flax_params):
    sd = params_from_flax(flax_params, PCFG)
    model = LlavaOnevision(PCFG)
    assert set(sd) == set(model.state_dict())
    # conv kernel HWIO -> OIHW, dense [in, out] -> [out, in]
    conv = np.asarray(flax_params["vision_tower"]["patch_embedding"]["kernel"])
    np.testing.assert_array_equal(sd["vision_tower.patch_embedding.weight"].numpy(),
                                  conv.transpose(3, 2, 0, 1))
    q = np.asarray(flax_params["language_model"]["layers_1"]["self_attn"]["q_proj"]["kernel"])
    np.testing.assert_array_equal(sd["language_model.layers.1.self_attn.q_proj.weight"].numpy(), q.T)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_siglip_tower_matches_flax(flax_params, batch, attn_impl):
    pixels = batch["student_pixel_values"][0, :3]  # [3, H, W, 3]
    want_last, want_post = FlaxSigLIP(CFG.vision).apply(
        {"params": flax_params["vision_tower"]}, jnp.asarray(pixels))
    model = _port_model(flax_params, attn_impl)
    with torch.no_grad():
        last, post = model.vision_tower(_t(pixels))
    _close(last, want_last)
    _close(post, want_post)


def test_qwen2_lm_no_cache_matches_flax(flax_params, batch):
    ids, mask = batch["student_input_ids"], batch["student_attention_mask"]
    want, _ = FlaxQwen2LM(CFG.text).apply(
        {"params": flax_params["language_model"]},
        input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    model = _port_model(flax_params)
    with torch.no_grad():
        got, caches = model.language_model(input_ids=_t(ids).long(), attention_mask=_t(mask))
    assert caches is None
    _close(got, want)


def _prefill_args(ids, lengths, total):
    s = ids.shape[1]
    q_pos = np.arange(s)[None, :, None]
    k_pos = np.arange(total)[None, None, :]
    mask = (k_pos <= q_pos) & (k_pos < lengths[:, None, None])
    return mask[:, None]


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_qwen2_lm_with_cache_matches_flax(flax_params, attn_impl):
    """Prefill at S=128 (so the port's flash arm takes the flash branch)
    into a fresh cache, then one decode step at per-sample offsets."""
    c = CFG.text
    rng = np.random.default_rng(2)
    b, s, n = 2, 128, 4
    total = s + n
    ids = rng.integers(0, 400, size=(b, s)).astype(np.int32)
    lengths = np.array([128, 97])
    prefill_mask = _prefill_args(ids, lengths, total)
    shape = (b, total, c.num_key_value_heads, c.head_dim)
    flax_caches = [{"k": jnp.zeros(shape), "v": jnp.zeros(shape)} for _ in range(c.num_hidden_layers)]
    lm = FlaxQwen2LM(c)
    p = {"params": flax_params["language_model"]}
    want_pre, flax_caches = lm.apply(
        p, input_ids=jnp.asarray(ids), positions=jnp.broadcast_to(jnp.arange(s)[None], (b, s)),
        caches=flax_caches, cache_index=jnp.int32(0), decode_mask=jnp.asarray(prefill_mask))

    model = _port_model(flax_params, attn_impl)
    caches = [{"k": torch.zeros(shape), "v": torch.zeros(shape)} for _ in range(c.num_hidden_layers)]
    with torch.no_grad():
        got_pre, caches = model.language_model(
            input_ids=_t(ids).long(), positions=torch.arange(s)[None].expand(b, s),
            caches=caches, cache_index=0, decode_mask=_t(prefill_mask))
    _close(got_pre, want_pre)
    for fc, tc in zip(flax_caches, caches):
        _close(tc["k"], fc["k"])
        _close(tc["v"], fc["v"])

    tok = rng.integers(0, 400, size=(b, 1)).astype(np.int32)
    pos = lengths.astype(np.int32)
    step_mask = (np.arange(total)[None, None, :] <= pos[:, None, None])[:, None]
    want_step, flax_caches = lm.apply(
        p, input_ids=jnp.asarray(tok), positions=jnp.asarray(pos[:, None]),
        caches=flax_caches, cache_index=jnp.asarray(pos), decode_mask=jnp.asarray(step_mask))
    with torch.no_grad():
        got_step, caches = model.language_model(
            input_ids=_t(tok).long(), positions=_t(pos[:, None]).long(), caches=caches,
            cache_index=_t(pos).long(), decode_mask=_t(step_mask))
    _close(got_step, want_step)
    for fc, tc in zip(flax_caches, caches):
        _close(tc["k"], fc["k"])


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_llava_forward_matches_flax(flax_params, batch, attn_impl):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_logits, want_vf, _ = FlaxLlava(CFG).apply(
        {"params": flax_params},
        input_ids=jb["student_input_ids"],
        attention_mask=jb["student_attention_mask"],
        pixel_values=jb["student_pixel_values"],
        **{k: jb[k] for k in BATCH_KEYS[1:]})
    model = _port_model(flax_params, attn_impl)
    with torch.no_grad():
        logits, vf, caches = model(
            input_ids=_t(batch["student_input_ids"]).long(),
            attention_mask=_t(batch["student_attention_mask"]),
            pixel_values=_t(batch["student_pixel_values"]),
            **{k: _t(batch[k]) for k in BATCH_KEYS[1:]})
    assert caches is None
    assert logits.shape == (2, 64, CFG.text.vocab_size)
    _close(logits, want_logits)
    _close(vf, want_vf)


def _tiny_hf_model():
    from transformers import (
        LlavaOnevisionConfig,
        LlavaOnevisionForConditionalGeneration,
        Qwen2Config,
        SiglipVisionConfig,
    )

    torch.manual_seed(0)
    v, t = CFG.vision, CFG.text
    hf_cfg = LlavaOnevisionConfig(
        vision_config=SiglipVisionConfig(
            hidden_size=v.hidden_size, intermediate_size=v.intermediate_size,
            num_hidden_layers=v.num_hidden_layers,
            num_attention_heads=v.num_attention_heads,
            image_size=v.image_size, patch_size=v.patch_size,
            vision_use_head=False,
        ),
        text_config=Qwen2Config(
            vocab_size=t.vocab_size, hidden_size=t.hidden_size,
            intermediate_size=t.intermediate_size,
            num_hidden_layers=t.num_hidden_layers,
            num_attention_heads=t.num_attention_heads,
            num_key_value_heads=t.num_key_value_heads,
            rope_theta=t.rope_theta, rms_norm_eps=t.rms_norm_eps,
            tie_word_embeddings=t.tie_word_embeddings,
            max_position_embeddings=2048,
        ),
        image_token_index=CFG.image_token_id,
        tie_word_embeddings=t.tie_word_embeddings,
    )
    return LlavaOnevisionForConditionalGeneration(hf_cfg).eval()


def test_hf_snapshot_route_matches_hf_forward(tmp_path):
    hf = _tiny_hf_model()
    snap = tmp_path / "snapshot"
    hf.save_pretrained(snap, safe_serialization=True)

    model = LlavaOnevision(PCFG)
    model.load_state_dict(load_llava_onevision_params(str(snap), PCFG))
    model.eval()

    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, 400, size=(2, 9))).long()
    mask = torch.ones_like(ids)
    with torch.no_grad():
        want = hf(input_ids=ids, attention_mask=mask).logits
        got, _, _ = model(input_ids=ids, attention_mask=mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)


def test_pack_taps_backward_equals_the_gather_gradient():
    """The anyres pack's deterministic backward (one product with the tap
    matrix) gives the bank the gradient that autograd through
    ``torch.gather`` gives it, with taps that repeat bank rows within and
    across packed positions, and zero-weight taps."""
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.models.llava_onevision import (
        _PackTaps,
    )

    g = torch.Generator().manual_seed(0)
    b, n, m, d = 2, 9, 13, 5
    bank = torch.randn(b, n, d, generator=g, requires_grad=True)
    idx = torch.randint(0, n, (b, m, 4), generator=g)
    idx[:, :, 1] = idx[:, :, 0]  # two taps of one position on the same row
    w = torch.rand(b, m, 4, generator=g)
    w[:, ::3, 3] = 0.0
    cot = torch.randn(b, m, d, generator=g)
    got = _PackTaps.apply(bank, idx, w)
    (g_got,) = torch.autograd.grad(got, bank, cot)
    want = sum(torch.gather(bank, 1, idx[:, :, k, None].expand(-1, -1, d)) * w[:, :, k, None] for k in range(4))
    (g_want,) = torch.autograd.grad(want, bank, cot)
    assert torch.equal(got, want)
    np.testing.assert_allclose(g_got.numpy(), g_want.numpy(), rtol=1e-6, atol=1e-6)


# --- SigLIP on the valid anyres tiles only -----------------------------------

def _lo():
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.models import (
        llava_onevision,
    )
    return llava_onevision


def _inputs(batch):
    return dict(input_ids=_t(batch["student_input_ids"]).long(),
                attention_mask=_t(batch["student_attention_mask"]),
                pixel_values=_t(batch["student_pixel_values"]),
                **{k: _t(batch[k]) for k in BATCH_KEYS[1:]})


def _all_tiles_forward(model, input_ids, attention_mask, pixel_values, pack_idx, pack_weight, pack_valid,
                       tile_valid):
    """The all-tiles form: the tower and the projector over every tile, the
    pooled features masked by ``tile_valid`` after pooling."""
    b, p = pixel_values.shape[:2]
    last, post = model.vision_tower(pixel_values.flatten(0, 1))
    projected = model.multi_modal_projector(last).reshape(b, p, *last.shape[1:2], -1)
    packed = model.pack_features(projected, pack_idx, pack_weight, pack_valid)
    embeds = model.merge_image_features(input_ids, model.language_model.embed(input_ids), packed)
    vf = post.reshape(b, p, *post.shape[1:]).mean(dim=2) * tile_valid[..., None].to(post.dtype)
    logits, _, hidden = model.language_model(inputs_embeds=embeds, attention_mask=attention_mask,
                                             return_hidden=True)
    return logits, vf, hidden


def _loss_and_grads(model, outs):
    """A loss that reads the pack (logits, hidden states) and every pooled
    feature, and its gradient at every leaf."""
    logits, vf, hidden = outs
    g = torch.Generator().manual_seed(7)
    loss = (logits.square().mean() + (hidden * torch.randn(hidden.shape, generator=g)).mean()
            + (vf * torch.randn(vf.shape, generator=g)).sum())
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return {n: torch.zeros_like(p) if gr is None else gr for n, p, gr in zip(names, leaves, grads)}


def _valid_tiles_forward(model, inputs):
    logits, vf, _, hidden = model(**inputs, return_hidden=True)
    return logits, vf, hidden


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_valid_tiles_match_the_all_tiles_form(flax_params, batch, attn_impl):
    tv = batch["tile_valid"]
    assert 0 < tv.sum() < tv.size  # the batch has padded tiles
    inputs = _inputs(batch)
    model = _port_model(flax_params, attn_impl).train()
    got = _valid_tiles_forward(model, inputs)
    want = _all_tiles_forward(model, **inputs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w.detach().numpy(), atol=1e-5, rtol=1e-5)
    g_got, g_want = _loss_and_grads(model, got), _loss_and_grads(model, want)
    assert any(g.abs().sum() > 0 for n, g in g_got.items() if n.startswith("vision_tower.post_layernorm"))
    for n in g_want:
        np.testing.assert_allclose(g_got[n].numpy(), g_want[n].numpy(), atol=1e-5, rtol=1e-4, err_msg=n)


def test_nan_pixels_in_padded_tiles_change_nothing(flax_params, batch):
    inputs = _inputs(batch)
    dirty = dict(inputs, pixel_values=inputs["pixel_values"].clone())
    dirty["pixel_values"][~inputs["tile_valid"]] = float("nan")
    model = _port_model(flax_params).train()
    clean_out, dirty_out = _valid_tiles_forward(model, inputs), _valid_tiles_forward(model, dirty)
    clean_g, dirty_g = _loss_and_grads(model, clean_out), _loss_and_grads(model, dirty_out)
    for c, d in list(zip(clean_out, dirty_out)) + [(clean_g[n], dirty_g[n]) for n in clean_g]:
        assert torch.isfinite(d).all()
        assert torch.equal(c, d)


def test_tile_counters_read_valid_and_padded_tiles(flax_params, batch):
    lo = _lo()
    model = _port_model(flax_params)
    lo.reset_tile_counts()
    with torch.no_grad():
        model(**_inputs(batch))
    tv = batch["tile_valid"]
    assert (lo.tiles_encoded, lo.tiles_skipped) == (int(tv.sum()), int(tv.size - tv.sum()))


@pytest.mark.parametrize("layout", ["none", "all_valid"])
def test_unpadded_layouts_run_the_whole_batch(flax_params, batch, layout, monkeypatch):
    lo = _lo()
    inputs = _inputs(batch)
    inputs["tile_valid"] = None if layout == "none" else torch.ones_like(inputs["tile_valid"])
    model = _port_model(flax_params)
    gathers = []
    real_select = torch.Tensor.index_select
    monkeypatch.setattr(torch.Tensor, "index_select", lambda *a, **k: gathers.append(1) or real_select(*a, **k))
    lo.reset_tile_counts()
    with torch.no_grad():
        got = _valid_tiles_forward(model, inputs)
        want = _all_tiles_forward(model, **dict(inputs, tile_valid=torch.ones_like(_t(batch["tile_valid"]))))
    b, p = inputs["pixel_values"].shape[:2]
    assert (lo.tiles_encoded, lo.tiles_skipped) == (b * p, 0)
    assert not gathers
    for g, w in zip(got, want):
        assert torch.equal(g, w)
