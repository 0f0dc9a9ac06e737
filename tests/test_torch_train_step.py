"""The port's baseline train step on the CPU against the JAX package's, on
the same weights (``params_from_flax``) and the same batch (two different
micro-batches from ``synthetic_kd_batch`` on the accumulation axis), tiny
config, float32:

* the loss equals JAX ``make_loss_fn`` (baseline, ``ce_impl="chunked"``),
  rtol 1e-5;
* every gradient leaf, carried back with ``flax_from_state_dict``, equals
  ``jax.grad``'s, atol 1e-5 / rtol 1e-3;
* the loss trace of 3 ``make_train_step`` steps at lr 1e-3 equals JAX's,
  rtol 1e-4, for each accumulation-carry dtype;
* AdamW with the phase-freeze masks equals optax on identical gradients,
  rtol 1e-5 (as tests/test_train_step.py holds optax to torch);
* bf16 parameters are updated through float32 masters that equal optax's
  float32 parameters, rtol 1e-5, and survive a checkpoint round trip."""

import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax.training.train_state import TrainState as FlaxTrainState

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.configs import (
    TrainConfig,
    llava_onevision_tiny,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.models import (
    LlavaOnevision as FlaxLlava,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.train import (
    KDModels as JaxKDModels,
    cosine_annealing_schedule as jax_cosine,
    make_optimizer as jax_make_optimizer,
    make_train_step as jax_make_train_step,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.train.step import (
    make_loss_fn as jax_make_loss_fn,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.utils.synthetic import (
    synthetic_kd_batch,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.configs import (
    TrainConfig as PortTrainConfig,
    llava_onevision_tiny as port_llava_onevision_tiny,
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
    cosine_annealing_schedule,
    make_eval_step,
    make_loss_fn,
    make_optimizer,
    make_train_step,
    phase_trainable_mask,
)

CFG = llava_onevision_tiny()
PCFG = port_llava_onevision_tiny()  # the port's own copy of the preset
LR = 1e-3


def _cfg(**kw):
    return TrainConfig(kd_mode="baseline", ce_impl="chunked", loss_chunk_size=32, **kw)


def _port_cfg(**kw):
    return PortTrainConfig(kd_mode="baseline", ce_impl="chunked", loss_chunk_size=32, **kw)


@pytest.fixture(scope="module")
def setup():
    micros = [synthetic_kd_batch(CFG, batch_size=2, seq_len=96, seed=s) for s in (3, 4)]
    batch = {k: np.stack([m[k] for m in micros]) for k in micros[0]}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.jit(FlaxLlava(CFG).init)(
        jax.random.PRNGKey(0),
        input_ids=jb["student_input_ids"][0],
        attention_mask=jb["student_attention_mask"][0],
        pixel_values=jb["student_pixel_values"][0],
        pack_idx=jb["pack_idx"][0],
        pack_weight=jb["pack_weight"][0],
        pack_valid=jb["pack_valid"][0],
        tile_valid=jb["tile_valid"][0],
    )["params"]
    return params, batch


def _port_model(params):
    model = LlavaOnevision(PCFG, attn_impl="xla")
    model.load_state_dict(params_from_flax(params, PCFG))
    return model.train()


def _torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _micro(batch, a):
    return {k: v[a] for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_loss_and_grads(setup):
    params, batch = setup
    loss_fn = jax_make_loss_fn(JaxKDModels(FlaxLlava(CFG)), _cfg())
    micro = {k: jnp.asarray(v[0]) for k, v in batch.items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, None, micro)
    return float(loss), grads


def test_loss_matches_jax(setup, jax_loss_and_grads):
    params, batch = setup
    model = _port_model(params)
    loss, metrics = make_loss_fn(KDModels(model), _port_cfg())(_micro(_torch_batch(batch), 0))
    np.testing.assert_allclose(loss.item(), jax_loss_and_grads[0], rtol=1e-5)
    assert metrics["loss"].dtype == torch.float32 and set(metrics) == {"ce", "loss"}


def test_every_gradient_leaf_matches_jax(setup, jax_loss_and_grads):
    params, batch = setup
    model = _port_model(params)
    loss, _ = make_loss_fn(KDModels(model), _port_cfg())(_micro(_torch_batch(batch), 0))
    names, leaves = zip(*model.named_parameters())
    # unused parameters (the tower's post_layernorm feeds only feature KD)
    # get zero gradients, as jax.grad gives them
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(torch.autograd.grad(loss, leaves, allow_unused=True), leaves)]
    grads = flax_from_state_dict(dict(zip(names, grads)))
    want = jax.tree_util.tree_flatten_with_path(jax_loss_and_grads[1])[0]
    got = dict((jax.tree_util.keystr(k), v)
               for k, v in jax.tree_util.tree_flatten_with_path(grads)[0])
    assert len(got) == len(want)
    for path, w in want:
        key = jax.tree_util.keystr(path)
        np.testing.assert_allclose(got[key], np.asarray(w), atol=1e-5, rtol=1e-3, err_msg=key)


@pytest.mark.parametrize("accum_dtype", ["float32", "bfloat16", "param"])
def test_three_step_loss_trace_matches_jax(setup, accum_dtype):
    params, batch = setup
    cfg = _cfg(accum_dtype=accum_dtype)
    jax_step = jax.jit(jax_make_train_step(JaxKDModels(FlaxLlava(CFG)), cfg))
    jstate = FlaxTrainState.create(apply_fn=None, params=params, tx=jax_make_optimizer(params, LR))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = []
    for _ in range(3):
        jstate, m = jax_step(jstate, None, jb)
        want.append(float(m["loss"]))

    model = _port_model(params)
    state = TrainState(model, make_optimizer(model, LR))
    step = make_train_step(KDModels(model), _port_cfg(accum_dtype=accum_dtype))
    tb = _torch_batch(batch)
    got = []
    for _ in range(3):
        state, m = step(state, None, tb)
        got.append(m["loss"].item())
    assert state.step == 3 and state.optimizer.count == 3
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[2] < got[0]


def test_eval_step_is_the_loss_without_gradients(setup, jax_loss_and_grads):
    params, batch = setup
    model = _port_model(params)
    m = make_eval_step(KDModels(model), _port_cfg())(None, None, _micro(_torch_batch(batch), 0))
    assert not m["loss"].requires_grad
    np.testing.assert_allclose(m["loss"].item(), jax_loss_and_grads[0], rtol=1e-5)


class _TwoRoots(torch.nn.Module):
    """Parameters rooted like the student's: vision_tower.* and language_model.*."""

    def __init__(self, tree):
        super().__init__()
        for root, leaves in tree.items():
            mod = torch.nn.Module()
            for name, arr in leaves.items():
                setattr(mod, name, torch.nn.Parameter(torch.tensor(np.asarray(arr))))
            setattr(self, root, mod)


@pytest.mark.parametrize("kd_mode,phase", [
    ("baseline", 0), ("double_trouble", 1), ("double_trouble", 2), ("double_trouble", 3),
])
def test_adamw_and_phase_masks_match_optax(kd_mode, phase):
    rng = np.random.default_rng(8)
    tree = {
        "vision_tower": {"w": rng.normal(size=(8, 6)).astype(np.float32)},
        "language_model": {"w": rng.normal(size=(5,)).astype(np.float32),
                           "b": rng.normal(size=(3, 3)).astype(np.float32)},
    }
    grads = [jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), tree)
             for _ in range(3)]

    params = jax.tree.map(jnp.asarray, tree)
    tx = jax_make_optimizer(params, LR, weight_decay=0.01, kd_mode=kd_mode, phase=phase)
    opt_state = tx.init(params)
    for g in grads:
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, params)
        params = optax.apply_updates(params, updates)

    module = _TwoRoots(tree)
    opt = make_optimizer(module, LR, weight_decay=0.01, kd_mode=kd_mode, phase=phase)
    for g in grads:
        opt.apply({f"{r}.{n}": torch.from_numpy(a) for r, leaves in g.items() for n, a in leaves.items()})
    for root, leaves in tree.items():
        for name, start in leaves.items():
            got = getattr(getattr(module, root), name).detach().numpy()
            np.testing.assert_allclose(got, np.asarray(params[root][name]), rtol=1e-5, atol=1e-7)
            frozen = not phase_trainable_mask([f"{root}.{name}"], kd_mode, phase)[f"{root}.{name}"]
            assert np.array_equal(got, start) == frozen
            # autograd computes no gradient for what the phase freezes
            assert getattr(getattr(module, root), name).requires_grad == (not frozen)


def _bf16_tree(rng, scale):
    """float32 leaves that bf16 holds exactly, so that the JAX float32
    params and the port's bf16 params start from the same values."""
    def leaf(*shape):
        x = torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))
        return x.to(torch.bfloat16).float().numpy()

    return {"vision_tower": {"w": leaf(8, 6)}, "language_model": {"w": leaf(64,)}}


def _bf16_module(tree):
    return _TwoRoots(tree).to(torch.bfloat16)


def test_bf16_params_update_through_float32_masters():
    # lr 2e-5 on weights of magnitude ~0.02: each update is below half a
    # bf16 ulp, so without a float32 master the weights would not move
    lr, rng = 2e-5, np.random.default_rng(9)
    tree = _bf16_tree(rng, 0.02)
    grads = [jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32) * 1e-3, tree)
             for _ in range(3)]
    params = jax.tree.map(jnp.asarray, tree)
    tx = jax_make_optimizer(params, lr, weight_decay=0.01)
    opt_state = tx.init(params)
    for g in grads:
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, params)
        params = optax.apply_updates(params, updates)

    module = _bf16_module(tree)
    opt = make_optimizer(module, lr, weight_decay=0.01)
    for i, g in enumerate(grads):
        opt.apply({f"{r}.{n}": torch.from_numpy(a) for r, leaves in g.items() for n, a in leaves.items()})
        if i == 0:  # Adam's first update is ~lr on every entry
            for root, leaves in tree.items():
                for name, start in leaves.items():
                    assert np.abs(opt.masters[f"{root}.{name}"].numpy() - start).min() > 0.5 * lr
    for root, leaves in tree.items():
        for name in leaves:
            key = f"{root}.{name}"
            master = opt.masters[key]
            assert master.dtype == torch.float32
            np.testing.assert_allclose(master.numpy(), np.asarray(params[root][name]), rtol=1e-5, atol=1e-9)
            param = getattr(getattr(module, root), name)
            assert param.dtype == torch.bfloat16 and torch.equal(param.detach(), master.to(torch.bfloat16))
    for st in opt.opt.state.values():
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32


def test_optimizer_state_round_trip_keeps_the_masters():
    rng = np.random.default_rng(10)
    tree = _bf16_tree(rng, 0.02)
    grads = [{f"{r}.{n}": torch.from_numpy(rng.normal(size=a.shape).astype(np.float32))
              for r, leaves in tree.items() for n, a in leaves.items()} for _ in range(3)]
    module = _bf16_module(tree)
    opt = make_optimizer(module, 2e-5)
    opt.apply(grads[0])
    buf = io.BytesIO()  # as a checkpoint file: the state dicts hold live tensors
    torch.save({"params": module.state_dict(), "opt_state": opt.state_dict()}, buf)
    buf.seek(0)
    saved = torch.load(buf, weights_only=True)
    opt.apply(grads[1])
    opt.apply(grads[2])

    resumed = _bf16_module(tree)
    resumed.load_state_dict(saved["params"])
    opt2 = make_optimizer(resumed, 2e-5)
    opt2.load_state_dict(saved["opt_state"])
    assert opt2.count == 1
    opt2.apply(grads[1])
    opt2.apply(grads[2])
    for key, master in opt.masters.items():
        assert torch.equal(opt2.masters[key], master)
    for a, b in zip(module.parameters(), resumed.parameters()):
        assert torch.equal(a, b)


def test_cosine_schedule_matches_jax():
    want = jax_cosine(1e-5, 10, steps_per_epoch=7)
    got = cosine_annealing_schedule(1e-5, 10, steps_per_epoch=7)
    for step in range(0, 75, 4):
        assert abs(got(step) - float(want(step))) < 1e-12


def test_optimizer_follows_its_schedule():
    module = _TwoRoots({"vision_tower": {"w": np.ones(3, np.float32)}})
    opt = make_optimizer(module, 1e-2, cosine_t_max=2, steps_per_epoch=1)
    lrs = []
    for _ in range(3):
        opt.apply({"vision_tower.w": torch.ones(3)})
        lrs.append(opt.opt.param_groups[0]["lr"])
    np.testing.assert_allclose(lrs, [1e-2, 5e-3, 0.0], atol=1e-12)


@pytest.mark.parametrize("kd_mode,phase", [
    ("logit_based", 0), ("double_trouble", 2), ("double_trouble", 3),
    ("double_trouble", 1), ("feature_based", 0),
])
def test_kd_modes_need_a_teacher(setup, kd_mode, phase):
    model = _port_model(setup[0])
    with pytest.raises(ValueError, match="requires a teacher"):
        make_loss_fn(KDModels(model), PortTrainConfig(kd_mode=kd_mode, phase=phase))
