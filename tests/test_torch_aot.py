"""The port's memory planner (``parallel/aot.py``) and the launchers that
fake mode can trace (``ops/_build.py``), on the CPU.

* Planner bytes: the port's ``sharded_param_bytes`` on models built on
  ``meta`` equals the JAX ``sharded_param_bytes`` on the Flax parameter
  shapes, byte for byte: the width-exact 2-layer pair (student, bf16
  teacher, ``int8_full`` teacher with the int8 embedding and head) at
  meshes (1, 2, 4), (1, 1, 8) and (2, 2, 2); the full-depth teacher counts
  7.5e9-8.5e9 parameters, and its bf16 bytes at (1, 2, 4) stay under
  2.2 P / 8 (``tests/test_7b_scale.py``'s bound for the JAX model).
  ``placed_param_bytes`` against a hand count of what ``shard_params``
  places.
* Launch contract: every kernel entry's route on fake CUDA tensors
  (``FakeTensorMode``) allocates outputs of its plain version's shapes and
  dtypes, and the kernel library is never loaded; a real CPU tensor at a
  launcher still goes on to the launch (and fails there).  A CPU-only build
  of torch takes the CUDA device guard in Python indexing
  (``Tensor.__getitem__``) and in autograd's input metadata, so these
  calls run the op functions directly, without autograd, and
  ``_basic_indexing`` routes the slices that K10's wrapper takes through
  ``aten`` ops.
* Planner step: the single-process planner at 2 layers (the CPU routes:
  autograd cannot record a fake CUDA tensor on a CPU-only build) holds, at
  the step's start, exactly the bf16 parameters, the float32 masters, the
  two float32 AdamW moments and step counters and the batch, and peaks
  above that; under a fake process group of 8 ranks at (1, 2, 4) each rank
  holds less than the single process, FSDP2's unsharded parameters appear
  in the tracker, and the group is left as it was found.
"""

import ast
import math
import os
import time

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.overrides import TorchFunctionMode

import jax
import jax.numpy as jnp

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.models import (
    LlavaOnevision as JaxLlavaOnevision,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.ops.int8 import (
    quantize_lm_params_int8,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.parallel import aot as jaot
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.parallel.mesh import (
    MeshConfig as JaxMeshConfig,
    make_mesh as jax_make_mesh,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.utils.synthetic import (
    synthetic_kd_batch as jax_synthetic_kd_batch,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops import (
    _build,
    flash_attention as fa,
    flash_phase_ablation as k13,
    fused_ce as fc,
    fused_kl as fkl,
    fused_loca as fl,
    int8 as i8,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.parallel import aot
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.parallel.mesh import (
    MeshConfig,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.parallel.sharding import (
    tensor_plan,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.utils.synthetic import (
    synthetic_kd_batch,
)

MESHES = ((1, 2, 4), (1, 1, 8), (2, 2, 2))
# (model, teacher_quant, teacher_embed_quant)
MODELS = (("student", "none", "none"), ("teacher", "none", "none"), ("teacher", "int8_full", "int8"))


def _jax_params(cfg, prefix, quant, embed_quant):
    """The Flax parameter shapes of ``cfg`` in bf16, quantized as asked (the
    JAX ``scripts/aot_7b.py``'s cross-check)."""
    b = jax_synthetic_kd_batch(cfg, batch_size=1, seq_len=3072, orig_sizes=[(530, 730)], seed=0)
    micro = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in b.items()}
    model = JaxLlavaOnevision(cfg, dtype=jnp.bfloat16)

    def init(ids, am, pv, pidx, pw, pva, tv):
        return model.init(jax.random.PRNGKey(0), input_ids=ids, attention_mask=am, pixel_values=pv,
                          pack_idx=pidx, pack_weight=pw, pack_valid=pva, tile_valid=tv)["params"]

    p = jax.eval_shape(init, micro[f"{prefix}_input_ids"], micro[f"{prefix}_attention_mask"],
                       micro[f"{prefix}_pixel_values"], micro["pack_idx"], micro["pack_weight"],
                       micro["pack_valid"], micro["tile_valid"])
    p = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.bfloat16 if s.dtype == jnp.float32 else s.dtype), p)
    if quant != "none":
        p = jax.eval_shape(lambda t: quantize_lm_params_int8(
            t, include_vision=quant == "int8_full", include_embed_head=embed_quant == "int8"), p)
    return p


_PAIRS = {}


def _pair(which, quant, embed_quant):
    """(JAX parameter shapes, the port's model on meta) of the width-exact
    2-layer pair, built once per model."""
    key = (which, quant, embed_quant)
    if key not in _PAIRS:
        scfg, tcfg = aot.teacher_7b_student_05b(layers=2)
        jscfg, jtcfg = jaot.teacher_7b_student_05b(layers=2)
        student, teacher = aot.meta_models(scfg, tcfg, quant, embed_quant)
        cfg = jscfg if which == "student" else jtcfg
        _PAIRS[key] = (_jax_params(cfg, which, quant, embed_quant), student if which == "student" else teacher)
    return _PAIRS[key]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("model", MODELS, ids=lambda m: "-".join(m))
def test_sharded_param_bytes_equal_the_jax_arithmetic(model, mesh):
    jparams, port_model = _pair(*model)
    want = jaot.sharded_param_bytes(jparams, jax_make_mesh(JaxMeshConfig(*mesh)))
    got = aot.sharded_param_bytes(port_model, MeshConfig(*mesh))
    assert got == want
    # the same count from an {axis: size} dict
    assert aot.sharded_param_bytes(port_model, dict(zip(("data", "fsdp", "tensor"), mesh))) == want


def test_full_depth_teacher_fits_the_jax_bound():
    scfg, tcfg = aot.teacher_7b_student_05b()
    _, teacher = aot.meta_models(scfg, tcfg)
    n_params = sum(p.numel() for p in teacher.parameters())
    assert 7.5e9 < n_params < 8.5e9, n_params
    bf16_bytes = aot.sharded_param_bytes(teacher, MeshConfig(1, 2, 4))
    assert bf16_bytes < 2.2 * n_params / 8, bf16_bytes
    _, int8_teacher = aot.meta_models(scfg, tcfg, "int8_full")
    assert aot.sharded_param_bytes(int8_teacher, MeshConfig(1, 2, 4)) < 0.65 * bf16_bytes


def _hand_placed(model, t, f):
    plan = tensor_plan(model, t)
    want = 0
    for name, p in model.named_parameters():
        module, _, leaf = name.rpartition(".")
        rows = p.shape[0] // t if plan.get(module) == "colwise" else p.shape[0]
        cols = p.numel() // p.shape[0]
        if plan.get(module) == "rowwise" and leaf in ("weight", "weight_q"):
            cols //= t
        want += math.ceil(rows / f) * cols * p.element_size()
    return want


@pytest.mark.parametrize("mesh", ((1, 2, 4), (1, 8, 1), (1, 1, 8), (1, 1, 4)), ids=lambda m: "x".join(map(str, m)))
def test_placed_param_bytes_follow_shard_params(mesh):
    """Rank 0's parameter bytes after ``shard_params``: the tensor-plan
    Linears and QLinears hold 1/t of their weight (a column-wise one of its
    bias and scales too), every parameter, int8, float32 or bf16, then
    splits dim 0 over fsdp into padded chunks.  An int8_full teacher with
    the int8 embedding and head is split as the bf16 one is, apart from
    SigLIP's MLP (whole over tensor: 4304 / t is no multiple of 16)."""
    d, f, t = mesh
    whole = {}
    for quant, embed in (("none", "none"), ("int8_full", "int8")):
        _, teacher = _pair("teacher", quant, embed)
        want = _hand_placed(teacher, t, f)
        assert aot.placed_param_bytes(teacher, MeshConfig(*mesh)) == want
        whole[quant] = sum(p.numel() * p.element_size() for p in teacher.parameters())
        assert (t == 1 and f == 1) or want < whole[quant]
        plan = tensor_plan(teacher, t)
        if quant != "none":
            assert not any(".mlp.fc" in n for n in plan)
            assert t < 2 or "language_model.layers.0.mlp.down_proj" in plan
            assert t not in (2, 4) or "language_model.layers.0.self_attn.o_proj" in plan
    assert whole["int8_full"] < whole["none"]


# ---------------------------------------------------------------- launches


class _basic_indexing(TorchFunctionMode):
    """``Tensor.__getitem__`` with integer and slice indices through
    ``aten.select`` / ``aten.slice``, which a fake CUDA tensor takes on a
    CPU-only build (Python indexing takes the CUDA device guard there)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.__getitem__:
            t, index = args
            dim = 0
            for i in index if isinstance(index, tuple) else (index,):
                if isinstance(i, int):
                    t = torch.ops.aten.select.int(t, dim, i)
                elif isinstance(i, slice) and i.step in (None, 1):
                    t = torch.ops.aten.slice.Tensor(t, dim, i.start, i.stop)
                    dim += 1
                else:
                    raise NotImplementedError(f"index {i!r}")
            return t
        return func(*args, **(kwargs or {}))


def _bf16(*shape):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(len(shape))).to(torch.bfloat16)


def _labels(n, v):
    return torch.randint(0, v, (n,), generator=torch.Generator().manual_seed(n), dtype=torch.int32)


N, V, DM = 8, 64, 896


def _loss_inputs():
    h, w = _bf16(N, DM), _bf16(V, DM)
    tmat = torch.randn(N, V, generator=torch.Generator().manual_seed(1))
    return h, w, tmat, _labels(N, V), _labels(N, V)


def _stats(n):
    return torch.rand(len(fl.ROW_STATS), n, generator=torch.Generator().manual_seed(2)) + 1.0


def _flash(shape_q, shape_k, causal):
    return _bf16(*shape_q), _bf16(*shape_k), _bf16(*shape_k), causal


def _flash_bwd(shape_q, shape_k):
    q, k, v, _ = _flash(shape_q, shape_k, True)
    b, s, h, _ = shape_q
    lse = torch.rand(b, h, s, generator=torch.Generator().manual_seed(3)) + 1.0
    return q, k, v, _bf16(*shape_q), lse, torch.zeros(b, h, s)


def _int8_inputs(n, k, m):
    wq = torch.randint(-127, 128, (m, k), generator=torch.Generator().manual_seed(4), dtype=torch.int8)
    return _bf16(n, k), wq, torch.rand(m, generator=torch.Generator().manual_seed(5)) + 0.5


# name (chip_smoke.KERNELS) -> (inputs, call); every kernel entry of the port
ENTRIES = {
    "flash_fwd_mha": (lambda: _flash((1, 65, 2, 72), (1, 65, 2, 72), False),
                      lambda q, k, v, c: fa.flash_attention(q, k, v, causal=c)),
    "flash_fwd_gqa": (lambda: _flash((1, 70, 14, 64), (1, 70, 2, 64), True),
                      lambda q, k, v, c: fa.flash_attention_gqa(q, k, v, causal=c)),
    "flash_fwd_gqa_d128": (lambda: _flash((1, 70, 28, 128), (1, 70, 4, 128), True),
                           lambda q, k, v, c: fa.flash_attention_gqa(q, k, v, causal=c)),
    "flash_bwd_mha": (lambda: _flash_bwd((1, 65, 2, 72), (1, 65, 2, 72)),
                      lambda q, k, v, do, lse, dl: fa.flash_attention_bwd(q, k, v, do, lse, dl, causal=True)),
    "flash_bwd_gqa": (lambda: _flash_bwd((1, 70, 14, 64), (1, 70, 2, 64)),
                      lambda q, k, v, do, lse, dl: fa.flash_attention_gqa_bwd(q, k, v, do, lse, dl, causal=True)),
    "fused_ce_fwd": (lambda: _loss_inputs()[:2] + (_labels(N, V),), fc.lse_gold_fwd),
    "fused_ce_bwd": (lambda: _loss_inputs()[:2] + (_labels(N, V), torch.rand(N) + 3.0, torch.rand(N),
                                                     torch.rand(N)), fc.lse_gold_bwd),
    "fused_loca_ce_fwd": (_loss_inputs, lambda h, w, t, a, b: fl.loca_ce_fwd(h, w, t, a, b, inv_t=0.5, alpha=0.8,
                                                                            eps=1e-8)),
    "fused_loca_ce_bwd": (lambda: _loss_inputs() + (_stats(N), torch.rand(N), torch.rand(N)),
                          lambda h, w, t, a, b, s, gk, gc: fl.loca_ce_bwd(h, w, t, a, b, s, gk, gc, inv_t=0.5,
                                                                         eps=1e-8)),
    "fused_loca_fwd": (lambda: _loss_inputs()[:4],
                       lambda h, w, t, a: fl.loca_fwd(h, w, t, a, inv_t=0.5, alpha=0.8, eps=1e-8)),
    "fused_loca_bwd": (lambda: _loss_inputs()[:4] + (_stats(N), torch.rand(N)),
                       lambda h, w, t, a, s, g: fl.loca_bwd(h, w, t, a, s, g, inv_t=0.5, eps=1e-8)),
    "fused_kl_fwd": (lambda: _loss_inputs()[:3], lambda h, w, t: fkl.kl_fwd(h, w, t, inv_t=0.5)),
    "fused_kl_bwd": (lambda: _loss_inputs()[:3] + (torch.rand(N) + 3.0, torch.rand(N) + 3.0, torch.rand(N)),
                     lambda h, w, t, ls, lt, g: fkl.kl_bwd(h, w, t, ls, lt, g, inv_t=0.5)),
    "int8_mm": (lambda: _int8_inputs(5, 128, 64), i8.int8_matmul),
    # K12's split form, one entry a kernel
    "int8_absmax": (lambda: (_bf16(5, 128),), i8.int8_row_absmax),
    "int8_quantize_given": (lambda: (_bf16(5, 128), torch.rand(5) + 0.5), i8.int8_quantize_rows),
    "int8_gemm_s32": (lambda: (_int8_inputs(12, 128, 64)[1][:12].contiguous(), _int8_inputs(12, 128, 64)[1]),
                      i8.int8_gemm_s32),
    "int8_epilogue": (lambda: (torch.randint(-2**20, 2**20, (5, 64), dtype=torch.int32), torch.rand(5),
                               torch.rand(64)), i8.int8_scale_epilogue),
    # the plain K10 takes float32 hidden states on the CPU (no bf16 x bf16 -> f32 mm there)
    "tmat_int8": (lambda: _int8_inputs(6, 128, 72),
                  lambda h, wq, ws: fl.materialize_teacher_logits_int8(h if h.is_cuda else h.float(), wq, ws,
                                                                       0.5, 64)),
    "flash_phase_ablation": (lambda: _flash((1, 70, 14, 64), (1, 70, 2, 64), True)[:3],
                             lambda q, k, v: k13.phase_ablation_forward(q, k, v, "full")),
    "flash_phase_ablation_d128": (lambda: _flash((1, 70, 28, 128), (1, 70, 4, 128), True)[:3],
                                  lambda q, k, v: k13.phase_ablation_forward(q, k, v, "full")),
}


def _outs(result):
    return [None if t is None else (tuple(t.shape), t.dtype)
            for t in (result if isinstance(result, tuple) else (result,))]


@pytest.fixture
def no_library(monkeypatch):
    """A kernel library that raises if anything loads it, and an H100's SM
    count for the vocab core's plan (a CPU-only build has no device to ask)."""
    calls = []

    def refuse():
        calls.append(1)
        raise RuntimeError("the kernel library must not be loaded here")

    monkeypatch.setattr(_build, "load_library", refuse)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d=None: type("P", (), {
        "multi_processor_count": 132})())
    return calls


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_fake_launch_allocates_the_plain_outputs(name, no_library):
    make, call = ENTRIES[name]
    args = make()
    with torch.no_grad():
        want = _outs(call(*args))
        with FakeTensorMode(allow_non_fake_inputs=True) as mode, _basic_indexing():
            fake = [torch.empty_strided(a.shape, a.stride(), dtype=a.dtype, device="cuda")
                    if isinstance(a, torch.Tensor) else a for a in args]
            got = call(*fake)
    assert _outs(got) == want
    assert all(t is None or (t.fake_mode is mode and t.device.type == "cuda")
               for t in (got if isinstance(got, tuple) else (got,)))
    assert no_library == []


def test_every_kernel_entry_is_covered():
    """ENTRIES names every entry of ``chip_smoke.py``'s KERNELS table."""
    tree = ast.parse(open(os.path.join(os.path.dirname(os.path.dirname(__file__)), "chip_smoke.py")).read())
    table = next(n.value for n in tree.body if isinstance(n, ast.Assign)
                 and any(getattr(t, "id", None) == "KERNELS" for t in n.targets))
    assert set(ENTRIES) == {k.value for k in table.keys}


@pytest.mark.parametrize("launcher", ["flash_fwd", "ce_fwd", "int8_gemm"])
def test_a_real_tensor_goes_on_to_the_launch(launcher, no_library):
    """A real (CPU) tensor is never taken for a traced one: the launcher
    goes on to load the library (here refused)."""
    args = {
        "flash_fwd": lambda: (*(_bf16(1, 64, 2, 64) for _ in range(3)), None, _bf16(1, 64, 2, 64), None, True, 0.125),
        "ce_fwd": lambda: (_bf16(N, DM), _bf16(V, DM), _labels(N, V), torch.empty(2, N), torch.empty(2, N),
                           torch.empty(N), torch.empty(N)),
        "int8_gemm": lambda: (torch.zeros(8, 128, dtype=torch.int8), torch.ones(8, 1),
                              torch.zeros(64, 128, dtype=torch.int8), torch.ones(64), torch.empty(8, 64,
                                                                                                 dtype=torch.bfloat16),
                              128),
    }[launcher]()
    with pytest.raises(RuntimeError, match="must not be loaded"):
        getattr(_build, launcher)(*args)
    assert no_library == [1]


# ---------------------------------------------------------------- the step


def _step_stats(mesh_cfg, mesh=None):
    scfg, tcfg = aot.teacher_7b_student_05b(layers=2)
    return aot.aot_compile_kd_step(scfg, tcfg, mesh_cfg, device="cpu", mesh=mesh)


def test_planner_arguments_are_the_hand_count():
    t0 = time.perf_counter()
    step, stats = _step_stats(MeshConfig())
    seconds = time.perf_counter() - t0
    assert seconds < 60, seconds
    student, teacher = step.models
    n_student = sum(p.numel() for p in student.parameters())
    n_tensors = sum(1 for _ in student.parameters())
    scfg, _ = aot.teacher_7b_student_05b(layers=2)
    batch = synthetic_kd_batch(scfg, batch_size=1, seq_len=3072, orig_sizes=[(530, 730)], accum=2, seed=0)
    want = (2 * n_student + 2 * sum(p.numel() for p in teacher.parameters())  # bf16 models
            + 4 * n_student  # float32 masters
            + 2 * 4 * n_student + 4 * n_tensors  # AdamW's moments and step counters
            + sum(v.nbytes for v in batch.values())
            + 8 * int(batch["tile_valid"].sum()))  # the valid tiles' int64 flat indices
    assert stats["argument_bytes"] == want
    assert stats["peak_bytes"] > stats["argument_bytes"]
    assert stats["temp_bytes"] == stats["peak_bytes"] - stats["argument_bytes"]
    assert stats["per_chip_hbm_estimate"] == stats["peak_bytes"]
    cats = stats["categories"]
    assert cats["at_start"]["Activation"] == 0 and cats["at_peak"]["Activation"] > 0
    assert cats["max"]["Gradient"] > 0


@pytest.fixture
def fake_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_mesh_planner_holds_less_a_rank(fake_group):
    one = _step_stats(MeshConfig())[1]
    _, stats = _step_stats(MeshConfig(1, 2, 4))
    assert stats["per_chip_hbm_estimate"] < one["per_chip_hbm_estimate"]
    assert stats["argument_bytes"] < one["argument_bytes"]
    cats = stats["categories"]
    assert cats["max"]["Unsharded Param"] > 0 and cats["at_start"]["Sharded Param"] > 0
    assert cats["at_start"]["OptState"] > 0


def test_mesh_planner_shards_the_int8_teacher(fake_group):
    """The int8_full teacher with the int8 embedding and head under the mesh
    planner at (1, 2, 4): FSDP2 over its int8 leaves (a root of its own),
    every leaf sharded again after the step (the root resharded once K10 has
    read the head), and less held a rank than with the bf16 teacher."""
    from torch.distributed.fsdp import FSDPModule
    from torch.distributed.tensor import DTensor

    scfg, tcfg = aot.teacher_7b_student_05b(layers=2)
    step, stats = aot.aot_compile_kd_step(scfg, tcfg, MeshConfig(1, 2, 4), device="cpu", teacher_quant="int8_full",
                                          teacher_embed_quant="int8")
    teacher = step.models.teacher
    assert isinstance(teacher, FSDPModule)
    assert all(isinstance(p, DTensor) for p in teacher.parameters())
    down = teacher.get_submodule("language_model.layers.0.mlp.down_proj").weight_q
    assert down.placements[-1].is_shard(1) and down.device_mesh.mesh_dim_names[-1] == "tensor"
    bf16 = _step_stats(MeshConfig(1, 2, 4))[1]
    assert stats["argument_bytes"] < bf16["argument_bytes"]
    assert stats["per_chip_hbm_estimate"] < bf16["per_chip_hbm_estimate"]

