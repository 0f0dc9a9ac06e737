"""The port's parallelism layer (``parallel/``) and the trainers' mesh
flags, on the CPU:

* ``MeshConfig`` (shape, device count, ``for_devices``) and the ``--mesh``
  parsing equal the JAX package's; ``make_mesh`` refuses a shape that is
  not the world size;
* the port's copy of the rule table gives, for every parameter of the 0.5B
  and 7B configs (built on the meta device), the spec JAX
  ``param_partition_specs`` gives on their abstract shapes, at meshes
  (1, 2, 4) and (1, 1, 8); ``_row_axes`` equals the JAX one;
* ``shard_params`` over two gloo ranks puts each tensor-parallel weight on
  the placement ``logical_to_sharding`` gives its spec, with local heads;
  the 0.5B plan leaves its 14/2-head attention whole at tensor = 4;
* the trainers take ``--distributed``, ``--mesh`` and the JAX
  ``--attn_impl`` values (``pallas``, ``pallas_spmd``, ``xla_chunked``);
  ``cli/train_online_kd.py --cpu --synthetic_data --distributed --mesh
  1,2,1`` under two ranks writes one checkpoint, which restores in one
  process: into a bare model and through the evaluator's
  ``--student_ckpt_path``; and ``--load_checkpoint`` of it under the same
  mesh trains on as a one-process resume does.
"""

import os
import shutil

import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu import configs as jcfg
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.models import (
    LlavaOnevision as FlaxLlava,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.ops.fused_spmd import (
    _row_axes as jax_row_axes,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.parallel import (
    MeshConfig as JaxMeshConfig,
    make_mesh as jax_make_mesh,
    param_partition_specs as jax_param_partition_specs,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch import configs as pcfg
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli import (
    common,
    evaluate_onevision,
    train,
    train_online_kd,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.models import LlavaOnevision
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops.fused_spmd import _row_axes
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.parallel import (
    MeshConfig,
    logical_to_sharding,
    make_mesh,
    param_partition_specs,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.parallel.mesh import parse_mesh
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.parallel.sharding import (
    flax_leaf,
    tensor_plan,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.train.checkpoint import (
    CheckpointManager,
    find_best_checkpoint,
)
from torch_dist_workers import kd_cli_worker, spawn, tensor_plan_worker


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Beside the suite's other workers (and the ranks this file spawns,
    one thread each) a full intra-op thread pool oversubscribes the cores,
    so this file runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n,tensor", [(1, None), (4, None), (8, None), (8, 4), (8, 2), (4, 1)])
def test_mesh_config_matches_jax(n, tensor):
    got, want = MeshConfig.for_devices(n, tensor), JaxMeshConfig.for_devices(n, tensor)
    assert (got.shape, got.num_devices) == (want.shape, want.num_devices)
    assert got == MeshConfig(*want.shape)


@pytest.mark.parametrize("text", ["1,1,1", "1,2,4", "2,2,2", "1,1,8"])
def test_mesh_flag_parses_as_jax(text):
    d, f, t = (int(x) for x in text.split(","))  # the JAX build_mesh's parse
    assert parse_mesh(text) == MeshConfig(d, f, t)
    assert train_online_kd.build_parser().parse_args(["--mesh", text, "--distributed"]).mesh == text
    assert train.build_parser().parse_args(["--mesh", text, "--distributed"]).distributed


def test_mesh_shape_must_match_the_world():
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh(MeshConfig(1, 2, 1))
    with pytest.raises(SystemExit, match="needs --distributed"):
        common.init_distributed(train_online_kd.build_parser().parse_args(["--mesh", "1,2,1"]))


def _abstract_params(jc):
    v = jc.vision
    s = jax.ShapeDtypeStruct
    kw = dict(input_ids=s((1, 8), jnp.int32), pixel_values=s((1, 1, v.image_size, v.image_size, 3), jnp.float32),
              pack_idx=s((1, 4, 4), jnp.int32), pack_weight=s((1, 4, 4), jnp.float32),
              pack_valid=s((1, 4), bool), tile_valid=s((1, 1), bool))
    model = FlaxLlava(jc)
    return jax.eval_shape(lambda **k: model.init(jax.random.PRNGKey(0), **k), **kw)["params"]


@pytest.mark.parametrize("size", ["0.5b", "7b"])
@pytest.mark.parametrize("shape", [(1, 2, 4), (1, 1, 8)])
def test_rule_table_matches_jax(size, shape):
    jc, pc = {"0.5b": (jcfg.llava_onevision_0_5b(), pcfg.llava_onevision_0_5b()),
              "7b": (jcfg.llava_onevision_7b(), pcfg.llava_onevision_7b())}[size]
    want = traverse_util.flatten_dict(jax_param_partition_specs(_abstract_params(jc),
                                                                jax_make_mesh(JaxMeshConfig(*shape))))
    got = param_partition_specs(LlavaOnevision(pc, device="meta"), dict(zip(("data", "fsdp", "tensor"), shape)))
    assert len(got) == len(want)
    for name, spec in got.items():
        path, perm = flax_leaf(name, len(spec))
        w = tuple(want[path]) + (None,) * (len(perm) - len(want[path]))
        assert tuple(spec[p] for p in perm) == w, name


@pytest.mark.parametrize("sizes", [dict(data=2, fsdp=2, tensor=2), dict(data=1, fsdp=2, tensor=4),
                                   dict(data=1, fsdp=1, tensor=8), dict(data=4, fsdp=1, tensor=2)])
@pytest.mark.parametrize("n", [24, 26, 30, 3072, 7])
def test_row_axes_match_jax(sizes, n):
    class Mesh:
        axis_names = tuple(sizes)
        shape = sizes

    assert _row_axes(sizes, n) == jax_row_axes(Mesh, n)


def test_tensor_plan_keeps_whole_heads():
    plan = tensor_plan(LlavaOnevision(pcfg.llava_onevision_0_5b(), device="meta"), 4)
    assert "language_model.layers.0.self_attn.q_proj" not in plan  # 14 q / 2 kv heads
    assert plan["language_model.layers.0.mlp.gate_proj"] == "colwise"
    assert plan["language_model.layers.0.mlp.down_proj"] == "rowwise"
    assert plan["vision_tower.layers.0.self_attn.k_proj"] == "colwise"  # 16 heads
    assert plan["multi_modal_projector.linear_2"] == "rowwise"
    plan2 = tensor_plan(LlavaOnevision(pcfg.llava_onevision_0_5b(), device="meta"), 2)
    assert plan2["language_model.layers.0.self_attn.o_proj"] == "rowwise"


def test_shard_params_places_the_table():
    (placed, _) = spawn(tensor_plan_worker, 2)
    model = LlavaOnevision(pcfg.llava_onevision_tiny(), device="meta")
    want = logical_to_sharding(param_partition_specs(model, dict(data=1, fsdp=1, tensor=2)), None)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    plan = tensor_plan(model, 2)
    # q/k/v/out and fc1/fc2 a SigLIP layer, q/k/v/o and gate/up/down a Qwen2 layer, the projector's two
    assert len(plan) == 6 * len(model.vision_tower.layers) + 7 * len(model.language_model.layers) + 2
    for name, (pl, local) in placed.items():
        assert pl is not None, name  # every parameter is an FSDP2 DTensor
        module = name.rpartition(".")[0]
        if module in plan:
            assert len(pl) == 2 and pl[-1] == want[name][-1], name  # (fsdp, tensor); tensor as the table says
            assert local[0] == shapes[name][0] // 2 if pl[-1].is_shard(0) else True
        else:  # FSDP's dim alone: replicated over tensor
            assert len(pl) == 1, name


@pytest.mark.parametrize("impl", ["pallas", "pallas_spmd", "xla_chunked", "flash", "xla"])
def test_trainers_take_the_jax_attn_impls(impl):
    for cli in (train_online_kd, train):
        args = cli.build_parser().parse_args(["--attn_impl", impl])
        assert common.resolve_attn_impl(args, torch.device("cpu"), pcfg.llava_onevision_tiny()) == impl


def _kd_cli_argv(data, ck, tb, *extra):
    return ["--cpu", "--synthetic_data", "--phase", "3", "--batch_size", "2", "--accumulate_grad_batches", "2",
            "--num_workers", "0", "--root_data_dir", str(data), "--checkpoint_dir", str(ck),
            "--tensorboard_dir", str(tb), *extra]


@pytest.fixture(scope="module")
def two_rank_run(tmp_path_factory):
    """One two-rank KD CLI run (mesh (1, 2, 1)): (data dir, its run dir)."""
    root = tmp_path_factory.mktemp("kd_cli")
    spawn(kd_cli_worker, 2, _kd_cli_argv(root / "data", root / "ck", root / "tb", "--distributed", "--mesh", "1,2,1"))
    return root / "data", root / "ck" / "kd_double_trouble_phase3"


def test_two_rank_kd_cli_checkpoint_restores_in_one_process(two_rank_run, tmp_path):
    data, run_dir = two_rank_run
    assert len(os.listdir(run_dir)) == 1
    path = find_best_checkpoint(str(run_dir))
    saved = torch.load(path, weights_only=True)
    fresh = LlavaOnevision(pcfg.llava_onevision_tiny())
    assert set(saved["params"]) == set(fresh.state_dict())
    assert all(v.dtype == torch.float32 for v in saved["params"].values())
    assert saved["step"] > 0 and saved["opt_state"]["count"] == saved["step"]
    assert len(saved["opt_state"]["adamw"]["state"]) == len(saved["params"])
    model = CheckpointManager(str(run_dir)).restore_model(path, LlavaOnevision(pcfg.llava_onevision_tiny()))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, saved["params"][k], rtol=0, atol=0)
    out = evaluate_onevision.main(["--synthetic_data", "--cpu", "--max_new_tokens", "2", "--root_data_dir",
                                   str(data), "--predictions_dir", str(tmp_path / "p"),
                                   "--student_ckpt_path", path])
    assert len(out["rows"]) > 0


def test_two_rank_resume_equals_one_process_resume(two_rank_run, tmp_path):
    """``--load_checkpoint`` of the two-rank run's checkpoint, once under the
    same mesh (the weights into the unsharded model, AdamW's state into the
    sharded optimizer) and once in one process: the same step count and
    AdamW update count, the same updated weights (within 2e-4, the drift
    yardstick of ``tests/test_train_step.py:264``)."""
    data, run_dir = two_rank_run
    runs = {}
    for label in ("mesh", "one"):
        ck = tmp_path / label
        shutil.copytree(run_dir, ck / "kd_double_trouble_phase3")
        argv = _kd_cli_argv(data, ck, tmp_path / "tb", "--load_checkpoint")
        if label == "mesh":
            spawn(kd_cli_worker, 2, argv + ["--distributed", "--mesh", "1,2,1"])
        else:
            train_online_kd.main(argv)
        best = find_best_checkpoint(str(ck / "kd_double_trouble_phase3"))
        runs[label] = torch.load(best, weights_only=True)
    first = torch.load(find_best_checkpoint(str(run_dir)), weights_only=True)
    a, b = runs["mesh"], runs["one"]
    assert a["step"] == b["step"] == 2 * first["step"]
    assert a["opt_state"]["count"] == b["opt_state"]["count"] == a["step"]
    for k, v in b["params"].items():
        assert (a["params"][k] - v).abs().max().item() <= 2e-4, k
    moved = sum(not torch.equal(v, first["params"][k]) for k, v in b["params"].items())
    assert moved > 0.9 * len(first["params"])  # the resumed run trained
