"""The int8 models under a mesh, on gloo ranks spawned on the CPU.

* K12's split form (``ops/int8.py::int8_matmul_rowwise``, its plain pieces
  here): at 2 and 4 ranks, column-wise (each rank's rows of the weight, the
  whole input) and row-wise (each rank's K columns of input and weight, the
  row absmax all-reduced by MAX, the int32 partial sums by SUM), bf16 and
  f32 out, at a ragged row count and at one row, held **bit for bit** to
  the JAX ``int8_matmul_xla`` on the same numpy inputs (bf16 x, the JAX
  ``absmax_quantize_weight``).  Two controls must break the bits: the
  absmax left local to each rank's columns, and one rank's int32 partials
  left out of the SUM.  With no group the split form equals
  ``int8_matmul`` bit for bit.
* A ``QLinear`` pair (column-wise, then row-wise, biases, a GELU between)
  split over 2 and 4 ranks by the int8 styles of ``parallel/sharding.py``:
  its output bit-equal to the pair in one process, each leaf placed as the
  styles say.
* ``shard_params`` on the tiny int8_full model and the tiny int8 teacher
  (int8 embedding and vocab-major head) at (1,1,2), (1,2,2), (1,1,4) and
  (1,2,1): each int8 leaf's tensor-parallel local shape is the JAX rule
  table's (``param_partition_specs`` of the JAX package on the quantized
  Flax parameters) wherever the pair rule splits; the embedding and head
  stay whole over tensor and every parameter is FSDP2-sharded; a rank's
  parameter bytes at rest equal ``parallel/aot.py::placed_param_bytes``.
* The pair rule's shape condition: a ``QLinear`` pair whose local K is no
  multiple of 16 stays whole (the tiny SigLIP attention at tensor = 4, the
  tiny teacher's attention at tensor = 2), where the float pair of the same
  shapes splits; and at the 7B's widths, SigLIP's int8 MLP stays whole
  (4304 / t) while its attention and the decoder's projections split.
"""

import math

import numpy as np
import pytest
import torch
from flax import traverse_util

import jax
import jax.numpy as jnp

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.configs import (
    llava_onevision_tiny,
    llava_onevision_tiny_teacher,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.models import (
    LlavaOnevision as FlaxLlava,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.ops import int8 as jint8
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.ops.int8 import (
    quantize_lm_params_int8,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.parallel.mesh import (
    MeshConfig as JaxMeshConfig,
    make_mesh as jax_make_mesh,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.parallel.sharding import (
    param_partition_specs as jax_param_partition_specs,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.utils.synthetic import (
    synthetic_kd_batch,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch import configs as pcfg
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.models import LlavaOnevision
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.models.convert import (
    params_from_flax,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops import int8
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops.int8 import (
    quantize_model_int8,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.parallel import aot
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.parallel.mesh import MeshConfig
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.parallel.sharding import (
    flax_leaf,
    tensor_plan,
)
from torch_dist_workers import (
    int8_pair,
    int8_pair_worker,
    int8_placement_worker,
    int8_split_worker,
    spawn,
    tiny_served_model,
    tiny_teacher,
)

WORLDS = (2, 4)
# (rows, K, M): a ragged row count and one row (the decode GEMM's shape)
SHAPES = ((37, 256, 64), (1, 512, 96))
FORMS = ("colwise", "rowwise")
OUTS = (torch.bfloat16, torch.float32)
CASES = [(form, out, shape) for form in FORMS for out in OUTS for shape in SHAPES]
IDS = [f"{f}-{str(o).split('.')[-1]}-{n}x{k}x{m}" for f, o, (n, k, m) in CASES]
MESHES = ((1, 1, 2), (1, 2, 2), (1, 1, 4), (1, 2, 1))
MODELS = ("student", "teacher")
PLACEMENT_CASES = [(mesh, which) for mesh in MESHES for which in MODELS]
KEYS = ("pack_idx", "pack_weight", "pack_valid", "tile_valid")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The ranks run one thread each; so does this file's own process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(n, k, m, seed):
    """bf16 x (as float32 values), and the JAX quantization of a [K, M]
    weight: (x, wq [M, K] in the port's layout, ws [M])."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, k)) * 3).astype(np.float32)
    x[0, :k // 2] *= 4  # row 0's absmax lies in the first half of K
    x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    wq, ws = jint8.absmax_quantize_weight(jnp.asarray((rng.standard_normal((k, m)) * 0.02).astype(np.float32)))
    return x, np.ascontiguousarray(np.asarray(wq).T), np.array(ws)


def _jax(x, wq, ws, out):
    jout = jnp.float32 if out == torch.float32 else jnp.bfloat16
    y = jint8.int8_matmul_xla(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(wq.T), jnp.asarray(ws), jout)
    return np.asarray(y.astype(jnp.float32))


@pytest.fixture(scope="module")
def split():
    cases = [(f, o, *_operands(*s, seed=i)) for i, (f, o, s) in enumerate(CASES)]
    return cases, {world: spawn(int8_split_worker, world, cases) for world in WORLDS}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_split_form_is_bit_equal_to_jax(split, world, case):
    cases, ranks = split
    form, out, x, wq, ws = cases[case]
    want = _jax(x, wq, ws, out)
    got = [r[case] for r in ranks[world]]
    if form == "colwise":
        y = torch.cat([g[0] for g in got], dim=1)
    else:
        for g in got[1:]:
            assert torch.equal(g[0], got[0][0]), "every rank holds the whole output"
        y = got[0][0]
    assert y.dtype == out and tuple(y.shape) == want.shape
    np.testing.assert_array_equal(y.float().numpy(), want)
    if form == "rowwise":
        # the absmax of each rank's own columns: row 0's scale is wrong on every rank but one
        assert not np.array_equal(got[-1][1].float().numpy(), want)
        # rank 0's int32 partials left out of the SUM
        assert not np.array_equal(got[0][2].float().numpy(), want)


@pytest.mark.parametrize("out", OUTS, ids=lambda o: str(o).split(".")[-1])
def test_split_form_without_a_group_is_int8_matmul(out):
    x, wq, ws = _operands(37, 256, 64, seed=9)
    xt, wqt, wst = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(wq), torch.from_numpy(ws)
    got = int8.int8_matmul_rowwise(xt, wqt, wst, None, out)
    assert torch.equal(got, int8.int8_matmul(xt, wqt, wst, out))
    # the pieces: the local amax is unclamped, the clamp comes with the quantize pass
    z = torch.zeros(2, 32, dtype=torch.bfloat16)
    assert torch.equal(int8.int8_row_absmax(z), torch.zeros(2))
    xq, xs = int8.int8_quantize_rows(z, int8.int8_row_absmax(z))
    assert torch.equal(xq, torch.zeros(2, 32, dtype=torch.int8))
    assert torch.equal(xs, torch.full((2,), 1e-6) / torch.full((2,), 127.0))
    assert int8.int8_gemm_s32(xq, torch.ones(8, 32, dtype=torch.int8)).dtype == torch.int32


@pytest.mark.parametrize("world", WORLDS)
def test_qlinear_pair_split_equals_one_process(world):
    pair = int8_pair()
    x = np.asarray(torch.randn(2, 9, 64, generator=torch.Generator().manual_seed(3)).to(torch.bfloat16).float())
    with torch.no_grad():
        want = pair(torch.from_numpy(x).to(torch.bfloat16))
    ranks = spawn(int8_pair_worker, world, pair.state_dict(), x)
    for y, placed in ranks:
        assert torch.equal(y, want)
        assert placed == {
            "fc1.weight_q": ("Shard(dim=0)", (128 // world, 64)), "fc1.weight_scale": ("Shard(dim=0)", (128 // world,)),
            "fc1.bias": ("Shard(dim=0)", (128 // world,)),
            "fc2.weight_q": ("Shard(dim=1)", (64, 128 // world)), "fc2.weight_scale": ("Replicate()", (64,)),
            "fc2.bias": ("Replicate()", (64,))}


@pytest.fixture(scope="module")
def flax_params():
    """{model: (the int8 Flax parameters, the port state dict of the float
    ones)} of the tiny model and the tiny teacher."""
    out = {}
    for which, cfg, prefix, pc in (("student", llava_onevision_tiny(), "student", pcfg.llava_onevision_tiny()),
                                   ("teacher", llava_onevision_tiny_teacher(), "teacher",
                                    pcfg.llava_onevision_tiny_teacher())):
        b = {k: jnp.asarray(v) for k, v in synthetic_kd_batch(llava_onevision_tiny(), 2, 96, seed=4).items()}
        params = FlaxLlava(cfg).init(
            jax.random.PRNGKey(0), input_ids=b[f"{prefix}_input_ids"], attention_mask=b[f"{prefix}_attention_mask"],
            pixel_values=b[f"{prefix}_pixel_values"], **{k: b[k] for k in KEYS})["params"]
        sd = params_from_flax(params, pc)
        out[which] = (quantize_lm_params_int8(params, include_vision=True, include_embed_head=which == "teacher"),
                      sd)
    return out


@pytest.fixture(scope="module")
def placed(flax_params):
    sds = {k: v[1] for k, v in flax_params.items()}
    out = {}
    for world in (2, 4):
        ranks = spawn(int8_placement_worker, world, PLACEMENT_CASES, sds)
        for case in ranks[0]:
            out[case] = [r[case] for r in ranks]
    assert set(out) == set(PLACEMENT_CASES)
    return out


def _local_model(which, sd):
    return tiny_teacher(sd, "int8") if which == "teacher" else tiny_served_model(sd, "int8_full")


@pytest.mark.parametrize("case", PLACEMENT_CASES, ids=lambda c: "x".join(map(str, c[0])) + f"-{c[1]}")
def test_int8_leaves_follow_the_jax_table(placed, flax_params, case):
    mesh, which = case
    t = mesh[2]
    jparams, sd = flax_params[which]
    want = traverse_util.flatten_dict(jax_param_partition_specs(jparams, jax_make_mesh(JaxMeshConfig(*mesh), jax.devices()[:math.prod(mesh)])))
    model = _local_model(which, sd)
    plan = tensor_plan(model, t)
    held, leaves = placed[case][0]
    assert set(leaves) == {n for n, _ in model.named_parameters()}
    split = 0  # int8 weights split over tensor
    for name, (shape, at_rest, local) in leaves.items():
        assert tuple(model.get_parameter(name).shape) == shape, name
        assert at_rest, f"{name} is not sharded by FSDP2"
        module = name.rpartition(".")[0]
        path, perm = flax_leaf(name, len(shape))
        spec = tuple(want[path]) + (None,) * (len(perm) - len(want[path]))
        table_local = list(shape)
        for j, p in enumerate(perm):
            if spec[j] == "tensor":
                table_local[p] //= t
        if module in plan:
            assert local == tuple(table_local), (name, local, table_local)
            split += name.endswith("weight_q") and local != shape
        else:
            assert local == shape, name  # whole over tensor
    assert (split > 0) == (t > 1)
    # the embedding and the int8 head stay whole over tensor
    assert not any(n.startswith(("language_model.embed_tokens", "language_model.lm_head")) for n in plan)
    # a rank's bytes at rest: placed_param_bytes (rank 0 holds the fullest FSDP2 chunks)
    meta = _local_model(which, sd)
    assert held == aot.placed_param_bytes(meta, MeshConfig(*mesh))
    assert all(r[0] <= held for r in placed[case])


def test_pair_rule_keeps_a_k12_misfit_whole():
    """A QLinear pair splits only where K12 takes every local shape."""
    tiny = LlavaOnevision(pcfg.llava_onevision_tiny(), device="meta")
    q_tiny = quantize_model_int8(LlavaOnevision(pcfg.llava_onevision_tiny(), device="meta"), include_vision=True)
    attn = "vision_tower.layers.0.self_attn.out_proj"
    # 4 heads at tensor = 4: the float pair splits; out_proj's local K = 32 / 4 = 8 keeps the int8 pair whole
    assert tensor_plan(tiny, 4)[attn] == "rowwise"
    assert attn not in tensor_plan(q_tiny, 4)
    assert tensor_plan(q_tiny, 4)["vision_tower.layers.0.mlp.fc2"] == "rowwise"  # local K = 16
    assert tensor_plan(q_tiny, 2)[attn] == "rowwise"
    # the tiny teacher's o_proj: K = 48 / 2 = 24 at tensor = 2
    teacher = quantize_model_int8(LlavaOnevision(pcfg.llava_onevision_tiny_teacher(), device="meta"))
    plan = tensor_plan(teacher, 2)
    assert "language_model.layers.0.self_attn.o_proj" not in plan
    assert plan["language_model.layers.0.mlp.down_proj"] == "rowwise"  # local K = 48


@pytest.mark.parametrize("t", (2, 4))
def test_7b_int8_plan(t):
    """At the 7B's widths every decoder projection and SigLIP's attention
    split; SigLIP's int8 MLP (fc2's local K = 4304 / t) stays whole."""
    model = quantize_model_int8(LlavaOnevision(pcfg.llava_onevision_7b(), device="meta"), include_vision=True)
    plan = tensor_plan(model, t)
    for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
        assert f"language_model.layers.0.self_attn.{name}" in plan
    for name in ("gate_proj", "up_proj", "down_proj"):
        assert f"language_model.layers.0.mlp.{name}" in plan
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        assert f"vision_tower.layers.0.self_attn.{name}" in plan
    assert not any(".mlp.fc" in n for n in plan)
    q = model.get_submodule("language_model.layers.0.self_attn.o_proj")
    assert q.weight_q.shape[1] // t in (1792, 896)


def test_shard_params_refuses_param_dtype_for_int8():
    """A model with int8 modules computes in its own dtypes: a
    ``param_dtype`` (a cast of every floating leaf, the one-byte FSDP2
    format of ``weight_q`` among them) is refused before anything moves."""
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.parallel.sharding import (
        shard_params,
    )

    model = quantize_model_int8(LlavaOnevision(pcfg.llava_onevision_tiny(), device="meta"), include_vision=True)
    with pytest.raises(ValueError, match="param_dtype must be None"):
        shard_params(model, None, param_dtype=torch.bfloat16)
    assert all(m.weight_q.dtype == torch.int8 for m in model.modules() if hasattr(m, "weight_q"))


@pytest.mark.parametrize("kind", ("linear", "embedding"))
def test_int8_modules_read_their_fsdp_format_back(kind):
    """``hold_for_fsdp`` re-registers ``weight_q`` in its one-byte FSDP2
    format, the same bytes; ``int8_weight`` and the forward read it back
    as int8, so the output does not move by a bit."""
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.models.qwen2 import (
        INT8_CARRIER,
        QEmbedding,
        QLinear,
    )

    g = torch.Generator().manual_seed(3)
    if kind == "linear":
        mod = QLinear.from_linear(torch.nn.Linear(64, 48).to(torch.bfloat16))
        x = torch.randn(5, 64, generator=g).to(torch.bfloat16)
    else:
        mod = QEmbedding.from_embedding(torch.nn.Embedding(40, 32).to(torch.bfloat16))
        x = torch.randint(0, 40, (3, 7), generator=g)
    wq, want = mod.weight_q.detach().clone(), mod(x)
    mod.hold_for_fsdp()
    assert mod.weight_q.dtype == INT8_CARRIER and not mod.weight_q.requires_grad
    assert torch.equal(mod.int8_weight(), wq)
    assert torch.equal(mod(x), want)
