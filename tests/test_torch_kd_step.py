"""The port's KD train step (logit_based, double_trouble phases 1, 2 and 3,
feature_based; logit_based and phases 2 and 3 also with
``loca_faithful_indexing``) on the CPU against the JAX package's, on the same weights (``params_from_flax``
for the tiny student and ``llava_onevision_tiny_teacher``, whose vocab is
the student's + 64, so the teacher logits are truncated) and the same batch
(two different micro-batches from ``synthetic_kd_batch`` on the
accumulation axis), float32:

* the loss and its terms (LoCa and CE; KL, NT-Xent and, in feature_based,
  CE) equal JAX ``make_loss_fn`` (``ce_impl="chunked"``), rtol 1e-5;
* every student gradient leaf, carried back with ``flax_from_state_dict``,
  equals ``jax.grad``'s, atol 1e-5 / rtol 1e-3;
* the loss trace of 3 ``make_train_step`` steps at lr 1e-3 (with the
  phase's freeze mask) equals JAX's, rtol 1e-4, the teacher does not move,
  and what the phase freezes does not move;
* ``make_eval_step`` gives the same loss and terms without gradients;
* ``ce_impl="chunked"`` (the plain autograd route, which never calls the
  fused wrappers) and ``"fused"`` (the wrappers, whose plain versions run on
  the CPU) agree in loss, terms and every gradient leaf, for every mode."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.training.train_state import TrainState as FlaxTrainState

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.configs import (
    TrainConfig,
    kd_loss_config_for,
    llava_onevision_tiny,
    llava_onevision_tiny_teacher,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.models import (
    LlavaOnevision as FlaxLlava,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.train import (
    KDModels as JaxKDModels,
    make_optimizer as jax_make_optimizer,
    make_train_step as jax_make_train_step,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.train.step import (
    make_loss_fn as jax_make_loss_fn,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.utils.synthetic import (
    synthetic_kd_batch,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch import (
    configs as pcfg,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.models import (
    LlavaOnevision,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.models.convert import (
    flax_from_state_dict,
    params_from_flax,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.train import (
    KDModels,
    TrainState,
    make_eval_step,
    make_loss_fn,
    make_optimizer,
    make_train_step,
)

SCFG, TCFG = llava_onevision_tiny(), llava_onevision_tiny_teacher()
LR = 1e-3
# (kd_mode, phase, loca_faithful_indexing)
MODES = [("logit_based", 0, False), ("double_trouble", 2, False), ("double_trouble", 3, False),
         ("double_trouble", 1, False), ("feature_based", 0, False),
         ("logit_based", 0, True), ("double_trouble", 2, True), ("double_trouble", 3, True)]
IDS = ["logit_based", "phase2", "phase3", "phase1", "feature_based",
       "logit_based_faithful", "phase2_faithful", "phase3_faithful"]
KEYS = ("pack_idx", "pack_weight", "pack_valid", "tile_valid")


def _jax_cfg(mode, phase, faithful=False):
    loss = dataclasses.replace(kd_loss_config_for(mode), loca_faithful_indexing=faithful)
    return TrainConfig(kd_mode=mode, phase=phase, loss=loss, ce_impl="chunked", loss_chunk_size=32)


def _port_cfg(mode, phase, faithful=False, ce_impl="fused"):
    loss = dataclasses.replace(pcfg.kd_loss_config_for(mode), loca_faithful_indexing=faithful)
    return pcfg.TrainConfig(kd_mode=mode, phase=phase, loss=loss, ce_impl=ce_impl, loss_chunk_size=32)


def _init(model, key, micro, prefix):
    return jax.jit(model.init)(
        key, input_ids=micro[f"{prefix}_input_ids"],
        attention_mask=micro[f"{prefix}_attention_mask"],
        pixel_values=micro[f"{prefix}_pixel_values"], **{k: micro[k] for k in KEYS},
    )["params"]


@pytest.fixture(scope="module")
def setup():
    assert TCFG.text.vocab_size == SCFG.text.vocab_size + 64
    assert not TCFG.text.tie_word_embeddings
    micros = [synthetic_kd_batch(SCFG, batch_size=2, seq_len=96, seed=s) for s in (3, 4)]
    batch = {k: np.stack([m[k] for m in micros]) for k in micros[0]}
    micro = {k: jnp.asarray(v[0]) for k, v in batch.items()}
    sparams = _init(FlaxLlava(SCFG), jax.random.PRNGKey(0), micro, "student")
    tparams = _init(FlaxLlava(TCFG), jax.random.PRNGKey(1), micro, "teacher")
    return sparams, tparams, batch


def _jax_models():
    return JaxKDModels(FlaxLlava(SCFG), FlaxLlava(TCFG))


def _port_models(sparams, tparams):
    student = LlavaOnevision(pcfg.llava_onevision_tiny(), attn_impl="xla")
    student.load_state_dict(params_from_flax(sparams, pcfg.llava_onevision_tiny()))
    teacher = LlavaOnevision(pcfg.llava_onevision_tiny_teacher(), attn_impl="xla")
    teacher.load_state_dict(params_from_flax(tparams, pcfg.llava_onevision_tiny_teacher()))
    return KDModels(student.train(), teacher.requires_grad_(False).eval())


def _torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _micro(batch, a):
    return {k: v[a] for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_loss_and_grads(setup):
    sparams, tparams, batch = setup
    micro = {k: jnp.asarray(v[0]) for k, v in batch.items()}
    out = {}
    for mode, phase, faithful in MODES:
        loss_fn = jax_make_loss_fn(_jax_models(), _jax_cfg(mode, phase, faithful))
        (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            sparams, tparams, micro)
        out[mode, phase, faithful] = ({k: float(v) for k, v in metrics.items()}, grads)
    return out


@pytest.mark.parametrize("mode,phase,faithful", MODES, ids=IDS)
def test_kd_loss_matches_jax(setup, jax_loss_and_grads, mode, phase, faithful):
    models = _port_models(*setup[:2])
    loss, metrics = make_loss_fn(models, _port_cfg(mode, phase, faithful))(_micro(_torch_batch(setup[2]), 0))
    want = jax_loss_and_grads[mode, phase, faithful][0]
    assert set(metrics) == set(want)
    assert all(v.dtype == torch.float32 for v in metrics.values())
    np.testing.assert_allclose(loss.item(), want["loss"], rtol=1e-5)
    for k in set(metrics) - {"loss"}:
        np.testing.assert_allclose(metrics[k].item(), want[k], rtol=1e-5, err_msg=k)
    assert want.get("loca", want.get("kl")) > 0


@pytest.mark.parametrize("mode,phase,faithful", MODES, ids=IDS)
def test_every_student_gradient_leaf_matches_jax(setup, jax_loss_and_grads, mode, phase, faithful):
    models = _port_models(*setup[:2])
    loss, _ = make_loss_fn(models, _port_cfg(mode, phase, faithful))(_micro(_torch_batch(setup[2]), 0))
    names, leaves = zip(*models.student.named_parameters())
    # the tower's post_layernorm feeds only feature KD: zero, as jax.grad gives
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(torch.autograd.grad(loss, leaves, allow_unused=True), leaves)]
    assert all(p.grad is None for p in models.teacher.parameters())
    grads = flax_from_state_dict(dict(zip(names, grads)))
    want = jax.tree_util.tree_flatten_with_path(jax_loss_and_grads[mode, phase, faithful][1])[0]
    got = dict((jax.tree_util.keystr(k), v)
               for k, v in jax.tree_util.tree_flatten_with_path(grads)[0])
    assert len(got) == len(want)
    for path, w in want:
        key = jax.tree_util.keystr(path)
        np.testing.assert_allclose(got[key], np.asarray(w), atol=1e-5, rtol=1e-3, err_msg=key)


@pytest.mark.parametrize("mode,phase,faithful", MODES, ids=IDS)
def test_three_step_loss_trace_matches_jax(setup, mode, phase, faithful):
    sparams, tparams, batch = setup
    jax_step = jax.jit(jax_make_train_step(_jax_models(), _jax_cfg(mode, phase, faithful)))
    tx = jax_make_optimizer(sparams, LR, kd_mode=mode, phase=phase)
    jstate = FlaxTrainState.create(apply_fn=None, params=sparams, tx=tx)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = []
    for _ in range(3):
        jstate, m = jax_step(jstate, tparams, jb)
        want.append(float(m["loss"]))

    models = _port_models(sparams, tparams)
    teacher_before = {k: v.clone() for k, v in models.teacher.state_dict().items()}
    tower_before = {k: v.clone() for k, v in models.student.vision_tower.state_dict().items()}
    lm_before = {k: v.clone() for k, v in models.student.language_model.state_dict().items()}
    state = TrainState(models.student, make_optimizer(models.student, LR, kd_mode=mode, phase=phase))
    step = make_train_step(models, _port_cfg(mode, phase, faithful))
    tb = _torch_batch(batch)
    got = []
    for _ in range(3):
        state, m = step(state, None, tb)
        got.append(m["loss"].item())
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[2] < got[0]
    for k, v in models.teacher.state_dict().items():
        assert torch.equal(v, teacher_before[k]), k
    # phase 2 freezes the vision tower, phase 1 the language model (the tied
    # head included); the other modes train both
    tower_moved = any(not torch.equal(v, tower_before[k])
                      for k, v in models.student.vision_tower.state_dict().items())
    assert tower_moved == (phase != 2)
    lm_moved = any(not torch.equal(v, lm_before[k])
                   for k, v in models.student.language_model.state_dict().items())
    assert lm_moved == (phase != 1 or mode != "double_trouble")


def test_eval_step_has_the_kd_terms_without_gradients(setup, jax_loss_and_grads):
    models = _port_models(*setup[:2])
    m = make_eval_step(models, _port_cfg("double_trouble", 3))(None, None,
                                                              _micro(_torch_batch(setup[2]), 0))
    want = jax_loss_and_grads["double_trouble", 3, False][0]
    for k in ("loss", "loca", "ce"):
        assert not m[k].requires_grad
        np.testing.assert_allclose(m[k].item(), want[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("mode,phase,faithful", MODES[3:5], ids=IDS[3:5])
def test_eval_step_has_the_kl_terms_without_gradients(setup, jax_loss_and_grads, mode, phase, faithful):
    models = _port_models(*setup[:2])
    m = make_eval_step(models, _port_cfg(mode, phase))(None, None, _micro(_torch_batch(setup[2]), 0))
    want = jax_loss_and_grads[mode, phase, faithful][0]
    assert set(m) == set(want)
    for k in want:
        assert not m[k].requires_grad
        np.testing.assert_allclose(m[k].item(), want[k], rtol=1e-5, err_msg=k)


def _loss_and_grads(models, cfg, micro):
    loss, metrics = make_loss_fn(models, cfg)(micro)
    names, leaves = zip(*models.student.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return metrics, {n: g for n, g in zip(names, grads) if g is not None}


@pytest.mark.parametrize("mode,phase,faithful", [("baseline", 0, False)] + MODES,
                         ids=["baseline"] + IDS)
def test_ce_impl_routes_agree(setup, monkeypatch, mode, phase, faithful):
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.train import step

    models = _port_models(*setup[:2])
    if mode == "baseline":
        models = KDModels(models.student)
    micro = _micro(_torch_batch(setup[2]), 0)
    m_fused, g_fused = _loss_and_grads(models, _port_cfg(mode, phase, faithful, "fused"), micro)

    def refuse(*a, **kw):
        raise AssertionError("the chunked route called a fused wrapper")

    # the step reaches the fused losses through their row-sharded wrappers
    # (ops/fused_spmd.py), the single-device losses when no mesh is active
    for name in ("fused_ce_loss_spmd", "fused_kl_loss_spmd", "fused_loca_ce_loss_spmd"):
        monkeypatch.setattr(step, name, refuse)
    m_chunk, g_chunk = _loss_and_grads(models, _port_cfg(mode, phase, faithful, "chunked"), micro)
    assert set(m_chunk) == set(m_fused) and set(g_chunk) == set(g_fused)
    for k in m_fused:
        np.testing.assert_allclose(m_chunk[k].item(), m_fused[k].item(), rtol=1e-5, err_msg=k)
    for k in g_fused:
        np.testing.assert_allclose(g_chunk[k].numpy(), g_fused[k].numpy(), atol=1e-5, rtol=1e-3, err_msg=k)


def test_unknown_ce_impl_is_refused(setup):
    with pytest.raises(ValueError, match="ce_impl"):
        make_loss_fn(_port_models(*setup[:2]), _port_cfg("logit_based", 0, ce_impl="xla"))


@pytest.mark.parametrize("mode,phase", [("double_trouble", 1), ("double_trouble", 3)], ids=["phase1", "phase3"])
def test_step_reads_the_tile_layout_once(setup, monkeypatch, mode, phase):
    """A step of A = 4 micro-batches, each with its own anyres layout, reads
    ``tile_valid`` to the host once (one call of ``tile_layouts``, the one
    helper that reads it), and both towers then encode only the valid tiles."""
    import importlib

    lo = importlib.import_module(
        "knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.models.llava_onevision")
    step_mod = importlib.import_module(
        "knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.train.step")
    sizes = [[(45, 67), (52, 72)], [(20, 200), (200, 20)], [(30, 30), (90, 40)], [(100, 100), (28, 28)]]
    micros = [synthetic_kd_batch(SCFG, batch_size=2, seq_len=96, orig_sizes=s, seed=i) for i, s in enumerate(sizes)]
    batch = _torch_batch({k: np.stack([m[k] for m in micros]) for k in micros[0]})
    reads, real = [], lo.tile_layouts

    def counted(*args, **kw):
        reads.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(lo, "tile_layouts", counted)
    monkeypatch.setattr(step_mod, "tile_layouts", counted)
    models = _port_models(*setup[:2])
    state = TrainState(models.student, make_optimizer(models.student, LR, kd_mode=mode, phase=phase))
    step = make_train_step(models, _port_cfg(mode, phase, ce_impl="chunked"))
    lo.reset_tile_counts()
    _, m = step(state, None, batch)
    assert len(reads) == 1
    assert torch.isfinite(m["loss"])
    tv = batch["tile_valid"]
    valid = int(tv.sum())
    assert len(set(tv.sum(dim=(1, 2)).tolist())) > 1  # the layouts differ between micro-batches
    assert (lo.tiles_encoded, lo.tiles_skipped) == (2 * valid, 2 * (tv.numel() - valid))
