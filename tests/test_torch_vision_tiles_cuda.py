"""SigLIP on the valid anyres tiles only, on the card: the full-width
so400m tower (2 layers) on the flash kernels K1/K2, bf16, under a 0.5B-wide
projector and a 1-layer Qwen2, on two SUNRGBD frames of 5 tiles each in the
10-tile budget.  The model's forward (the tower over the 10 valid tiles,
copied back into the padded layout) against the all-tiles form written out
here (the tower over all 20 tiles, the pooled features masked after
pooling): the hidden states, the pooled features and every gradient leaf of
a loss that reads both.  And the peak memory of the padded batch against
the same batch with every tile valid.  Needs a CUDA device; skips without
one.

Run on the card (the tests' conftest imports jax, which the card's machine
may lack):
    python -m pytest --noconftest -m cuda tests/test_torch_vision_tiles_cuda.py

Tolerances, those of ``tests/test_torch_kd_cuda.py``: relative Frobenius
error <= 1e-2 and max abs error <= 1e-2 x max(1, max |plain|).  Both sides
run the same kernels on the same tiles in bf16; only the row count of the
GEMMs, and so the summation order of the weight gradients, differs."""

import dataclasses

import pytest
import torch

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.configs import (
    llava_onevision_0_5b,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.models import (
    llava_onevision as lo,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops import (
    flash_attention as fa,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.utils.synthetic import (
    synthetic_kd_batch,
)

pytestmark = pytest.mark.cuda
TOL = 1e-2
FRO_TOL = 1e-2
FRAMES = [(530, 730), (480, 640)]  # kv2 and xtion frames: 5 anyres tiles each


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built for sm_90a)")
    return torch.device("cuda", 0)


def _cfg():
    cfg = llava_onevision_0_5b()
    return dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, num_hidden_layers=2),
                               text=dataclasses.replace(cfg.text, num_hidden_layers=1))


def _model(dev):
    model = lo.LlavaOnevision(_cfg(), attn_impl="flash", device=dev, dtype=torch.bfloat16)
    return lo.init_weights(model, 0).train()


def _batch(dev, all_valid=False):
    cfg = _cfg()
    b = synthetic_kd_batch(cfg, batch_size=2, seq_len=3072, orig_sizes=FRAMES, seed=0)
    b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    assert b["tile_valid"].sum(dim=1).tolist() == [5, 5] and b["tile_valid"].shape[1] == 10
    if all_valid:
        b["tile_valid"] = torch.ones_like(b["tile_valid"])
        g = torch.Generator(device=dev).manual_seed(1)
        b["student_pixel_values"] = torch.randn(b["student_pixel_values"].shape, generator=g, device=dev)
    inputs = dict(input_ids=b["student_input_ids"].long(), attention_mask=b["student_attention_mask"],
                  pixel_values=b["student_pixel_values"])
    inputs.update({k: b[k] for k in ("pack_idx", "pack_weight", "pack_valid", "tile_valid")})
    return inputs


def _all_tiles(model, input_ids, attention_mask, pixel_values, pack_idx, pack_weight, pack_valid, tile_valid):
    b, p = pixel_values.shape[:2]
    last, post = model.vision_tower(pixel_values.flatten(0, 1))
    projected = model.multi_modal_projector(last).reshape(b, p, last.shape[1], -1)
    packed = model.pack_features(projected, pack_idx, pack_weight, pack_valid)
    embeds = model.merge_image_features(input_ids, model.language_model.embed(input_ids), packed)
    vf = post.reshape(b, p, *post.shape[1:]).mean(dim=2) * tile_valid[..., None].to(post.dtype)
    _, _, hidden = model.language_model(inputs_embeds=embeds, attention_mask=attention_mask,
                                        return_hidden=True, compute_logits=False)
    return hidden, vf


def _valid_tiles(model, inputs):
    _, vf, _, hidden = model(**inputs, return_hidden=True, compute_logits=False)
    return hidden, vf


def _grads(model, hidden, vf, dev):
    g = torch.Generator(device=dev).manual_seed(2)
    loss = ((hidden.float() * torch.randn(hidden.shape, generator=g, device=dev)).mean()
            + (vf.float() * torch.randn(vf.shape, generator=g, device=dev)).sum())
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return {n: torch.zeros_like(p) if gr is None else gr for n, p, gr in zip(names, leaves, grads)}


def _close(got, want, name):
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    assert err <= TOL * max(1.0, want.abs().max().item()), (name, err)
    norm = want.norm().item()
    fro = (got - want).norm().item()
    assert fro <= FRO_TOL * norm if norm > 0 else fro == 0, (name, fro, norm)


def test_valid_tiles_match_the_masked_all_tiles_form(dev):
    model = _model(dev)
    inputs = _batch(dev)
    k1, k2 = fa.flash_attention.head_dim_launches.get(72, 0), fa.flash_attention_bwd.head_dim_launches.get(72, 0)
    lo.reset_tile_counts()
    got = _valid_tiles(model, inputs)
    g_got = _grads(model, *got, dev)
    assert (lo.tiles_encoded, lo.tiles_skipped) == (10, 10)
    # K1 and K2 ran the tower, once a layer each way
    assert fa.flash_attention.head_dim_launches.get(72, 0) - k1 == 2
    assert fa.flash_attention_bwd.head_dim_launches.get(72, 0) - k2 == 2
    want = _all_tiles(model, **inputs)
    g_want = _grads(model, *want, dev)
    for name, g, w in zip(("hidden", "vision_features"), got, want):
        _close(g, w, name)
    assert (got[1][~inputs["tile_valid"]] == 0).all()
    assert g_want["vision_tower.layers.0.self_attn.q_proj.weight"].abs().max() > 0
    for n in g_want:
        _close(g_got[n], g_want[n], n)


def _peak(model, inputs, dev):
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    grads = _grads(model, *_valid_tiles(model, inputs), dev)
    del grads
    torch.cuda.synchronize(dev)
    return torch.cuda.max_memory_allocated(dev) - base


def test_padded_batch_peaks_below_the_all_valid_batch(dev):
    model = _model(dev)
    padded, full = _batch(dev), _batch(dev, all_valid=True)
    _peak(model, padded, dev)  # warm: the kernels' workspaces and the allocator's pools
    p_padded, p_full = _peak(model, padded, dev), _peak(model, full, dev)
    assert p_padded < p_full, (p_padded, p_full)
