"""Remat, the sequence-chunked MLP and the query-chunked plain attention of
the port, on the CPU at the tiny configs:

* the phase-3 KD loss and every student gradient leaf with the student at
  each remat setting (``full``, ``dots``, ``flash``, ``full`` with
  ``mlp_chunk=32``, ``full`` with ``remat_barrier``) equal remat off (loss
  rtol 2e-5, leaves atol 1e-5 / rtol 1e-3), the student on the flash path
  (its plain version on the CPU), two micro-batches at S = 160;
* ``flash`` launches no second flash forward (the plain forward's call
  counter), ``full`` one a layer; ``dots`` recomputes no weight product in
  the backward (the products the dispatcher sees), ``full`` does;
* one ``make_train_step`` step with the student at ``remat=True,
  mlp_chunk=32, remat_barrier=True`` against JAX ``make_train_step`` with
  ``LlavaOnevision(SCFG, remat=True, mlp_chunk=32, remat_barrier=True)``:
  the loss at rtol 2e-5; the updated parameters elementwise (rtol 1e-3 /
  atol 1e-5) wherever the gradient is above 1e-6, a hundred times AdamW's
  eps, and within one step (2 lr) elsewhere: AdamW divides by |g|, so an
  entry whose gradient is near eps moves by an arbitrary part of lr in
  either framework (here a SigLIP layer-norm bias entry; the drift
  yardstick of ``tests/test_train_step.py:264`` holds JAX to JAX only);
* ``xla_chunked_attention`` against the JAX one: values and gradients,
  causal and kv-masked, Sq not a multiple of the chunk (atol 2e-5);
* the train CLIs build both models with remat at full width and without at
  tiny width (built on the meta device, not run).
"""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

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
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.ops.attention import (
    xla_chunked_attention as jax_chunked,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.train import (
    KDModels as JaxKDModels,
    make_optimizer as jax_make_optimizer,
    make_train_step as jax_make_train_step,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.utils.synthetic import (
    synthetic_kd_batch,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch import configs as pcfg
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli import (
    common,
    train,
    train_online_kd,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.models import LlavaOnevision
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.models.convert import (
    flax_from_state_dict,
    params_from_flax,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops import flash_attention as fa
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops.attention import (
    dot_product_attention,
    xla_chunked_attention,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.train import (
    KDModels,
    TrainState,
    make_loss_fn,
    make_optimizer,
    make_train_step,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.train import loop
from torch_dist_workers import record_grads

SCFG, TCFG = llava_onevision_tiny(), llava_onevision_tiny_teacher()
KEYS = ("pack_idx", "pack_weight", "pack_valid", "tile_valid")
SETTINGS = [dict(remat_policy="full"), dict(remat_policy="dots"), dict(remat_policy="flash"),
            dict(remat_policy="full", mlp_chunk=32), dict(remat_policy="full", remat_barrier=True)]
SETTING_IDS = ["full", "dots", "flash", "full-mlp_chunk32", "full-remat_barrier"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Beside the suite's other workers (and the ranks this file spawns,
    one thread each) a full intra-op thread pool oversubscribes the cores,
    so this file runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _init(model, key, micro, prefix):
    return jax.jit(model.init)(
        key, input_ids=micro[f"{prefix}_input_ids"],
        attention_mask=micro[f"{prefix}_attention_mask"],
        pixel_values=micro[f"{prefix}_pixel_values"], **{k: micro[k] for k in KEYS})["params"]


@pytest.fixture(scope="module")
def setup():
    micros = [synthetic_kd_batch(SCFG, batch_size=2, seq_len=160, seed=s) for s in (3, 4)]
    batch = {k: np.stack([m[k] for m in micros]) for k in micros[0]}
    micro = {k: jnp.asarray(v[0]) for k, v in batch.items()}
    sparams = _init(FlaxLlava(SCFG), jax.random.PRNGKey(0), micro, "student")
    tparams = _init(FlaxLlava(TCFG), jax.random.PRNGKey(1), micro, "teacher")
    return (params_from_flax(sparams, pcfg.llava_onevision_tiny()),
            params_from_flax(tparams, pcfg.llava_onevision_tiny_teacher()), batch)


def _models(ssd, tsd, attn_impl="flash", **remat):
    student = LlavaOnevision(pcfg.llava_onevision_tiny(), attn_impl=attn_impl, remat=bool(remat), **remat)
    student.load_state_dict(ssd)
    teacher = LlavaOnevision(pcfg.llava_onevision_tiny_teacher(), attn_impl=attn_impl)
    teacher.load_state_dict(tsd)
    return KDModels(student.train(), teacher.requires_grad_(False).eval())


def _cfg():
    return pcfg.TrainConfig(kd_mode="double_trouble", phase=3, loss=pcfg.kd_loss_config_for("double_trouble"),
                            ce_impl="fused", loss_chunk_size=32)


def _loss_and_grads(setup, **remat):
    ssd, tsd, batch = setup
    models = _models(ssd, tsd, **remat)
    micro = {k: torch.from_numpy(v[0]) for k, v in batch.items()}
    loss, _ = make_loss_fn(models, _cfg())(micro)
    names, leaves = zip(*models.student.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.item(), {n: (torch.zeros_like(p) if g is None else g) for n, g, p in zip(names, grads, leaves)}


@pytest.fixture(scope="module")
def plain(setup):
    return _loss_and_grads(setup)


@pytest.mark.parametrize("remat", SETTINGS, ids=SETTING_IDS)
def test_remat_loss_and_grads_match_remat_off(setup, plain, remat):
    loss, grads = _loss_and_grads(setup, **remat)
    np.testing.assert_allclose(loss, plain[0], rtol=2e-5)
    assert set(grads) == set(plain[1])
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), plain[1][k].numpy(), atol=1e-5, rtol=1e-3, err_msg=k)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] += 1
        return func(*args, **(kwargs or {}))


def _counts(setup, **remat):
    """(plain flash forwards in the whole step, weight products in the
    backward alone)."""
    ssd, tsd, batch = setup
    models = _models(ssd, tsd, **remat)
    micro = {k: torch.from_numpy(v[0]) for k, v in batch.items()}
    fa.reset_launch_counts()
    loss, _ = make_loss_fn(models, _cfg())(micro)
    with _CountOps() as mode:
        loss.backward()
    dots = mode.ops[torch.ops.aten.mm.default] + mode.ops[torch.ops.aten.addmm.default]
    return fa.flash_attention_ref.calls, dots


def test_flash_policy_runs_no_second_flash_forward_and_dots_no_second_product(setup):
    off, full, dots, flash = (_counts(setup, **kw) for kw in (
        {}, dict(remat_policy="full"), dict(remat_policy="dots"), dict(remat_policy="flash")))
    layers = SCFG.vision.num_hidden_layers + SCFG.text.num_hidden_layers  # S = 160: flash in every layer
    assert full[0] == off[0] + layers
    assert dots[0] == off[0] + layers
    assert flash[0] == off[0]
    assert dots[1] == off[1] < full[1]


def test_remat_step_matches_jax():
    batch = synthetic_kd_batch(SCFG, batch_size=2, seq_len=96, accum=2, seed=5)
    micro = {k: jnp.asarray(v[0]) for k, v in batch.items()}
    sparams = _init(FlaxLlava(SCFG), jax.random.PRNGKey(0), micro, "student")
    tparams = _init(FlaxLlava(TCFG), jax.random.PRNGKey(1), micro, "teacher")
    cfg = TrainConfig(kd_mode="double_trouble", phase=3, loss=kd_loss_config_for("double_trouble"),
                      loss_chunk_size=32)
    lever = FlaxLlava(SCFG, remat=True, mlp_chunk=32, remat_barrier=True)
    step = jax.jit(jax_make_train_step(JaxKDModels(lever, FlaxLlava(TCFG)), cfg))
    jstate = FlaxTrainState.create(apply_fn=None, params=sparams, tx=jax_make_optimizer(sparams, 1e-3))
    jstate, jm = step(jstate, tparams, {k: jnp.asarray(v) for k, v in batch.items()})

    models = _models(params_from_flax(sparams, pcfg.llava_onevision_tiny()),
                     params_from_flax(tparams, pcfg.llava_onevision_tiny_teacher()), attn_impl="xla",
                     remat_policy="full", mlp_chunk=32, remat_barrier=True)
    state = TrainState(models.student, make_optimizer(models.student, 1e-3))
    grads = record_grads(state.optimizer)
    state, m = make_train_step(models, _cfg())(state, None, {k: torch.from_numpy(np.asarray(v))
                                                             for k, v in batch.items()})
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=2e-5)

    def flat(tree):
        return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
                for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    got, want = flat(flax_from_state_dict(models.student.state_dict())), flat(jstate.params)
    g = flat(flax_from_state_dict(grads))
    assert set(got) == set(want) == set(g)
    for k, w in want.items():
        sure = np.abs(g[k]) > 1e-6
        np.testing.assert_allclose(got[k][sure], w[sure], rtol=1e-3, atol=1e-5, err_msg=k)
        assert np.abs(got[k] - w).max() <= 2e-3, k


CHUNK_CASES = [(causal, masked, sq, skv) for causal in (False, True) for masked in (False, True)
               for sq, skv in ((75, 75), (64, 64), (40, 70))]


@pytest.mark.parametrize("causal,masked,sq,skv", CHUNK_CASES)
def test_xla_chunked_attention_matches_jax(causal, masked, sq, skv):
    rng = np.random.default_rng(sq + 3 * skv + 7 * causal + 11 * masked)
    q = rng.normal(size=(2, sq, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, skv, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, skv, 2, 8)).astype(np.float32)
    r = rng.normal(size=(2, sq, 4, 8)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((2, skv), bool)
        mask[0, -9:] = False
        mask[1, :3] = False

    def jf(q_, k_, v_):
        out = jax_chunked(q_, k_, v_, kv_mask=None if mask is None else jnp.asarray(mask), causal=causal, chunk=32)
        return (out * r).sum(), out

    (_, jout), jgrads = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = xla_chunked_attention(tq, tk, tv, kv_mask=None if mask is None else torch.from_numpy(mask),
                                causal=causal, chunk=32)
    (out * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=2e-5)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    # the dispatch takes a [B, 1, 1, Skv] padding mask
    m4 = None if mask is None else torch.from_numpy(mask)[:, None, None, :]
    via = dot_product_attention(tq, tk, tv, mask=m4, causal=causal, impl="xla_chunked")
    np.testing.assert_allclose(via.detach().numpy(), np.asarray(jax_chunked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_mask=None if mask is None else jnp.asarray(mask),
        causal=causal)), atol=2e-5)


@pytest.mark.parametrize("cli,real", [(train_online_kd, True), (train_online_kd, False), (train, True),
                                      (train, False)], ids=["kd-full", "kd-tiny", "train-full", "train-tiny"])
def test_clis_remat_at_full_width_only(cli, real, tmp_path, monkeypatch):
    built = []
    original = common.init_or_load_params

    def on_meta(cfg, *a, **kw):
        kw["device"] = torch.device("meta")
        model = original(cfg, *a, **kw)
        built.append(model)
        return model

    def stop(models, cfg, state, *a, **kw):
        return state

    monkeypatch.setattr(common, "init_or_load_params", on_meta)
    monkeypatch.setattr(loop, "run_training", stop)
    argv = ["--cpu", "--synthetic_data", "--root_data_dir", str(tmp_path / "d"), "--num_workers", "0",
            "--checkpoint_dir", str(tmp_path / "ck")] + (["--real_model"] if real else [])
    cli.main(argv)
    assert len(built) == (2 if cli is train_online_kd else 1)
    wide = pcfg.llava_onevision_0_5b().text.hidden_size
    assert built[0].cfg.text.hidden_size == wide if real else built[0].cfg.text.hidden_size < wide
    for model in built:
        assert model.language_model.remat is real and model.vision_tower.remat is real
        assert model.language_model.remat_policy == "full" and model.language_model.mlp_chunk == 0
