"""The port's train step under a mesh, on gloo ranks spawned on the CPU:
the tiny double_trouble phase-3 and baseline steps (batch 2, seq 96,
accumulation 2, seed 5, the batch of the JAX ``tests/test_sharding.py``
step test) at meshes (2,1,1), (1,2,1), (1,1,2) and (1,2,2), the student and
teacher sharded by ``parallel.shard_params`` (FSDP2 over data/fsdp,
tensor parallelism over tensor), each rank on its rows of the batch
(``shard_batch``), the vocabulary terms by the fused route (the row-sharded
``ops/fused_spmd.py`` wrappers, their plain versions on the CPU) and by the
chunked route (``global_mean``); phase 3 with the int8 teacher (int8_full,
the int8 embedding and head) at (1,2,1), (1,1,2) and (1,2,2), the teacher
sharded by ``shard_params`` as a float one is (FSDP2 over every int8 leaf;
at tensor = 2 its MLP split by the int8 styles, the row-wise down_proj
through K12's split form; its attention stays whole, o_proj's local K of
24 being no multiple of 16); phase 1 at (1,2,1) and feature_based at
(1,2,2), whose NT-Xent takes every rank's tile features (``gather_rows``).

Against the one-process port step on the same weights and batch: the loss
(rtol 2e-4, the same on every rank) and every gradient leaf the optimizer
is given (atol 1e-5 / rtol 1e-3: this is where a gradient scale off by the
world size would show; AdamW's first step is blind to it).  Against the JAX
single-device step: the loss (rtol 2e-4).  Against both: the updated parameters, elementwise
(rtol 1e-3 / atol 1e-5) wherever the one-process gradient is above 1e-6,
a hundred times AdamW's eps, so that the first step's update is set by
the gradient's sign; elsewhere within one step (2 lr) of each other.  AdamW
divides by |g|, so an entry whose gradient is near eps moves by an
arbitrary part of lr (here a SigLIP layer-norm bias entry at |g| ~ 2e-9,
and the SigLIP key-projection bias, whose gradient is zero in exact
arithmetic: a vector added to every key shifts each query's scores by a
constant), in either program.
"""

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
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.ops.int8 import (
    quantize_lm_params_int8,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.train import (
    KDModels as JaxKDModels,
    make_optimizer as jax_make_optimizer,
    make_train_step as jax_make_train_step,
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
    make_optimizer,
    make_train_step,
)
from torch_dist_workers import kd_step_worker, record_grads, spawn, tiny_teacher

SCFG, TCFG = llava_onevision_tiny(), llava_onevision_tiny_teacher()
LR = 1e-3
MODES = [("double_trouble", 3), ("baseline", 0)]
MESHES = [(2, 1, 1), (1, 2, 1), (1, 1, 2), (1, 2, 2)]
CASES = [(mesh, mode, phase, ce, "bf16") for mesh in MESHES for mode, phase in MODES
         for ce in ("fused", "chunked")]
# the int8 teacher on a data-parallel mesh and split over tensor;
# NT-Xent over every rank's tile features (phase 1, feature_based)
CASES += [((1, 2, 1), "double_trouble", 3, "fused", "int8"), ((1, 2, 1), "double_trouble", 1, "fused", "bf16"),
          ((1, 2, 2), "feature_based", 0, "fused", "bf16"), ((1, 1, 2), "double_trouble", 3, "fused", "int8"),
          ((1, 2, 2), "double_trouble", 3, "fused", "int8")]
IDS = ["{}-{}-{}{}".format("x".join(map(str, c[0])), c[1] if c[1] != "double_trouble" else f"phase{c[2]}", c[3],
                           "-int8_teacher" if c[4] == "int8" else "") for c in CASES]
KEYS = ("pack_idx", "pack_weight", "pack_valid", "tile_valid")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Beside the suite's other workers (and the ranks this file spawns,
    one thread each) a full intra-op thread pool oversubscribes the cores,
    so this file runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loss_cfg(mode):
    return kd_loss_config_for(mode) if mode != "baseline" else None


@pytest.fixture(scope="module")
def setup():
    batch = synthetic_kd_batch(SCFG, batch_size=2, seq_len=96, accum=2, seed=5)
    micro = {k: jnp.asarray(v[0]) for k, v in batch.items()}

    def init(model, key, prefix):
        return jax.jit(model.init)(
            jax.random.PRNGKey(key), input_ids=micro[f"{prefix}_input_ids"],
            attention_mask=micro[f"{prefix}_attention_mask"],
            pixel_values=micro[f"{prefix}_pixel_values"], **{k: micro[k] for k in KEYS})["params"]

    sparams, tparams = init(FlaxLlava(SCFG), 0, "student"), init(FlaxLlava(TCFG), 1, "teacher")
    ssd = params_from_flax(sparams, pcfg.llava_onevision_tiny())
    tsd = params_from_flax(tparams, pcfg.llava_onevision_tiny_teacher())
    return sparams, tparams, ssd, tsd, {k: np.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_steps(setup):
    sparams, tparams, _, _, batch = setup
    out = {}
    for mode, phase, quant in sorted({(c[1], c[2], c[4]) for c in CASES}):
        kw = dict(kd_mode=mode, phase=phase, loss_chunk_size=32, learning_rate=LR)
        teacher, tp = None, None
        if mode != "baseline":
            kw["loss"] = _loss_cfg(mode)
            teacher, tp = FlaxLlava(TCFG), tparams
            if quant == "int8":
                teacher = FlaxLlava(TCFG, lm_quant="int8", vision_quant="int8", embed_quant="int8")
                tp = quantize_lm_params_int8(tparams, include_vision=True, include_embed_head=True)
        step = jax.jit(jax_make_train_step(JaxKDModels(FlaxLlava(SCFG), teacher), TrainConfig(**kw)))
        tx = jax_make_optimizer(sparams, LR, kd_mode=mode, phase=phase)
        state, m = step(FlaxTrainState.create(apply_fn=None, params=sparams, tx=tx), tp,
                        {k: jnp.asarray(v) for k, v in batch.items()})
        out[mode, phase, quant] = (float(m["loss"]), state.params)
    return out


@pytest.fixture(scope="module")
def one_process(setup):
    _, _, ssd, tsd, batch = setup
    out = {}
    for mode, phase, ce, quant in sorted({c[1:] for c in CASES}):
        student = LlavaOnevision(pcfg.llava_onevision_tiny(), attn_impl="xla")
        student.load_state_dict(ssd)
        teacher = None if mode == "baseline" else tiny_teacher(tsd, quant)
        lc = pcfg.kd_loss_config_for(mode) if mode != "baseline" else pcfg.KDLossConfig()
        cfg = pcfg.TrainConfig(kd_mode=mode, phase=phase, loss=lc, ce_impl=ce, loss_chunk_size=32)
        state = TrainState(student.train(), make_optimizer(student, LR, kd_mode=mode, phase=phase))
        grads = record_grads(state.optimizer)
        state, m = make_train_step(KDModels(student, teacher), cfg)(
            state, None, {k: torch.from_numpy(v) for k, v in batch.items()})
        out[mode, phase, ce, quant] = (m["loss"].item(),
                                       {k: v.clone() for k, v in student.state_dict().items()}, grads)
    return out


@pytest.fixture(scope="module")
def sharded(setup):
    _, _, ssd, tsd, batch = setup
    out = {}
    for world in (2, 4):
        ranks = spawn(kd_step_worker, world, CASES, ssd, tsd, batch, LR)
        for case in ranks[0]:
            assert len({r[case][0] for r in ranks}) == 1, "every rank holds the global loss"
        out.update(ranks[0])
    assert set(out) == set(CASES)
    return out


def _hold_params(got, want, grads, label):
    """Elementwise where the gradient sets AdamW's step, else within 2 lr."""
    for k, w in want.items():
        g, w = np.asarray(got[k], np.float32), np.asarray(w, np.float32)
        sure = np.abs(grads[k].numpy()) > 1e-6 if k in grads else np.ones(w.shape, bool)
        np.testing.assert_allclose(g[sure], w[sure], rtol=1e-3, atol=1e-5, err_msg=f"{label}: {k}")
        assert np.abs(g - w).max() <= 2 * LR, (label, k)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sharded_step_matches_one_process(sharded, one_process, case):
    loss, params, grads = sharded[case]
    want_loss, want_params, want_grads = one_process[case[1:]]
    np.testing.assert_allclose(loss, want_loss, rtol=2e-4)
    assert set(grads) == set(want_grads)
    for k, w in want_grads.items():
        np.testing.assert_allclose(grads[k].numpy(), w.numpy(), atol=1e-5, rtol=1e-3, err_msg=k)
    _hold_params(params, want_params, want_grads, "one process")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sharded_step_matches_jax(sharded, jax_steps, one_process, case):
    mesh, mode, phase, ce, quant = case
    loss, params, _ = sharded[case]
    grads = one_process[case[1:]][2]
    want_loss, want_params = jax_steps[mode, phase, quant]
    np.testing.assert_allclose(loss, want_loss, rtol=2e-4)
    got = jax.tree_util.tree_flatten_with_path(flax_from_state_dict(params))[0]
    want = dict((jax.tree_util.keystr(k), v) for k, v in jax.tree_util.tree_flatten_with_path(want_params)[0])
    assert len(got) == len(want)
    names = {jax.tree_util.keystr(k): ".".join(str(getattr(p, "key", p)) for p in k) for k, _ in got}
    _hold_params({names[jax.tree_util.keystr(k)]: v for k, v in got},
                 {names[k]: v for k, v in want.items()}, _flax_grads(grads), "jax")


def _flax_grads(grads):
    """Port gradients by name -> by dotted Flax path, in the Flax layout."""
    tree = flax_from_state_dict(grads)
    return {".".join(str(getattr(p, "key", p)) for p in k): torch.from_numpy(np.asarray(v))
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
