"""Device mesh construction (port of the JAX package's ``parallel/mesh.py``).

The mesh is a ``torch.distributed`` ``DeviceMesh`` over the ranks of the
process group, with the dims named (data, fsdp, tensor) from the outermost
to the innermost, so the ``tensor`` dim, whose all-reduces sit inside every
layer, joins neighbouring ranks (on one host: cards joined by NVLink), and
the once-a-step gradient reductions of ``data``/``fsdp`` take the rest.

The process group comes first (``cli/common.py::init_distributed``, or a
test's ``init_process_group``); :func:`make_mesh` then builds the mesh over
all of its ranks and refuses a shape that does not match the world size.
:func:`use_mesh` makes a mesh the active one (the JAX ``jax.set_mesh``), and
:func:`active_mesh` is the probe the mesh-aware code calls (the JAX
``active_abstract_mesh``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_TENSOR = "tensor"
AXIS_NAMES = (AXIS_DATA, AXIS_FSDP, AXIS_TENSOR)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical mesh shape.  ``data * fsdp * tensor`` must equal the number
    of ranks."""

    data: int = 1
    fsdp: int = 1
    tensor: int = 1

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.data, self.fsdp, self.tensor)

    @property
    def num_devices(self) -> int:
        return self.data * self.fsdp * self.tensor

    @staticmethod
    def for_devices(n: int, tensor: Optional[int] = None) -> "MeshConfig":
        """The default layout for ``n`` devices: everything on ``tensor``
        unless an explicit split is given; the rest on ``fsdp``, which also
        shards the student's optimizer state."""
        if tensor is None:
            tensor = n
        assert n % tensor == 0, (n, tensor)
        return MeshConfig(data=1, fsdp=n // tensor, tensor=tensor)


def parse_mesh(text: str) -> MeshConfig:
    """``"d,f,t"`` (the ``--mesh`` flag) -> MeshConfig."""
    parts = text.split(",")
    if len(parts) != 3:
        raise ValueError(f"--mesh takes data,fsdp,tensor, got {text!r}")
    d, f, t = (int(p) for p in parts)
    if min(d, f, t) < 1:
        raise ValueError(f"mesh sizes must be >= 1, got {text!r}")
    return MeshConfig(d, f, t)


def make_mesh(cfg: MeshConfig, device_type: Optional[str] = None):
    """The ``DeviceMesh`` of ``cfg`` over every rank of the process group,
    dims named ``AXIS_NAMES``.  ``device_type`` defaults to "cuda" under
    NCCL and "cpu" otherwise.  Raises ValueError when the shape does not
    match the world size (or no process group is up)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 0
    if cfg.num_devices != n:
        raise ValueError(f"mesh shape {cfg.shape} needs {cfg.num_devices} ranks, have {n}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, cfg.shape, mesh_dim_names=AXIS_NAMES)


_ACTIVE = [None]


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the active mesh inside the block (the JAX
    ``jax.set_mesh``); None leaves no mesh active."""
    prev, _ACTIVE[0] = _ACTIVE[0], mesh
    try:
        yield mesh
    finally:
        _ACTIVE[0] = prev


def active_mesh():
    """The mesh :func:`use_mesh` made active, or None."""
    return _ACTIVE[0]


def is_rank0() -> bool:
    """Rank 0 of the process group, or no process group at all."""
    return not dist.is_initialized() or dist.get_rank() == 0


def axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh.size(AXIS_NAMES.index(axis))


def axis_rank(mesh, axis: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def dp_size(mesh) -> int:
    """Ranks that hold distinct rows of the batch: data x fsdp."""
    return axis_size(mesh, AXIS_DATA) * axis_size(mesh, AXIS_FSDP)


def dp_rank(mesh) -> int:
    """This rank's shard of the batch over (data, fsdp), data outermost."""
    return axis_rank(mesh, AXIS_DATA) * axis_size(mesh, AXIS_FSDP) + axis_rank(mesh, AXIS_FSDP)


def all_reduce_sum(t: torch.Tensor, mesh, axes=(AXIS_DATA, AXIS_FSDP)) -> torch.Tensor:
    """Sum ``t`` in place over the mesh ``axes`` (one all-reduce a dim of
    size > 1).  A CUDA tensor under gloo goes through the host: gloo
    all-reduces host tensors (the sums here are scalars)."""
    for axis in axes:
        if axis_size(mesh, axis) == 1:
            continue
        group = mesh.get_group(axis)
        if t.device.type == "cuda" and dist.get_backend(group) == "gloo":
            host = t.detach().cpu()
            dist.all_reduce(host, group=group)
            t.copy_(host)
        else:
            dist.all_reduce(t, group=group)
    return t
