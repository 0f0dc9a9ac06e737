"""The memory planner (``parallel/aot.py``) on the card's machine, where the
traced step takes the kernel routes: the single-process planner at 2
layers reaches the flash and K11 launchers on fake CUDA tensors, and the
mesh planner at (1, 2, 4) over a fake process group of 8 ranks tracks
FSDP2's all-gather buffers and estimates less a rank than one process
holds.  Needs a CUDA device (``fully_shard`` on a CUDA mesh asks the
device); skips without one.

Run on the card (the tests' conftest imports jax, which the card's machine
may lack):
    python -m pytest --noconftest -m cuda tests/test_torch_aot_cuda.py
"""

import pytest
import torch
import torch.distributed as dist

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.parallel import aot
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.parallel.mesh import (
    MeshConfig,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (fake CUDA tensors under autograd, FSDP2 on a CUDA mesh)")
    return torch.device("cuda", 0)


@pytest.fixture
def fake_group(dev):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _plan(mesh_cfg, **kw):
    scfg, tcfg = aot.teacher_7b_student_05b(layers=2)
    return aot.aot_compile_kd_step(scfg, tcfg, mesh_cfg, **kw)[1]


def test_single_process_plan_takes_the_kernel_routes(dev):
    stats = _plan(MeshConfig())
    launches = stats["traced_launches"]
    assert launches["flash_fwd"] > 0 and launches["flash_bwd"] > 0 and launches["fused_loca_ce"] == 4
    assert stats["peak_bytes"] > stats["argument_bytes"] > 0
    assert torch.cuda.memory_allocated(dev) < 2**30  # nothing was materialized


def test_mesh_plan_tracks_the_all_gathers(dev, fake_group):
    one = _plan(MeshConfig(), teacher_quant="int8_full")
    stats = _plan(MeshConfig(1, 2, 4), teacher_quant="int8_full")
    cats = stats["categories"]["max"]
    assert cats["All Gather"] > 0 and cats["Unsharded Param"] > 0 and cats["Reduce Scatter"] > 0
    assert stats["per_chip_hbm_estimate"] < one["per_chip_hbm_estimate"]
    assert stats["traced_launches"]["flash_fwd"] > 0
