"""Partition rules for LLaVA-OneVision and their application with
``torch.distributed`` (port of the JAX package's ``parallel/sharding.py``).

The rule table is the JAX one, copied (the JAX module imports jax, so it is
not imported here; ``tests/test_torch_parallel.py`` holds the copy to the
original on every parameter of the 0.5B and 7B configs).  It is written on
the Flax parameter paths and layouts:

==============================  =======================  ====================
weight                          shape (Flax layout)      spec
==============================  =======================  ====================
embed_tokens.embedding          [V, D]                   (fsdp, tensor)
attn q/k/v kernel               [D, H*hd]                (fsdp, tensor)
attn q/k/v bias                 [H*hd]                   (tensor,)
attn o/out kernel               [H*hd, D]                (tensor, fsdp)
mlp up/gate/fc1 kernel          [D, I]                   (fsdp, tensor)
mlp down/fc2 kernel             [I, D]                   (tensor, fsdp)
lm_head kernel                  [D, V]                   (fsdp, tensor)
patch_embedding kernel          [kh, kw, C, D]           (None,None,None,tensor)
projector linear_1              [Dv, Dt]                 (fsdp, tensor)
projector linear_2              [Dt, Dt]                 (tensor, fsdp)
norm scales/biases, newline     [D] / [T, D]             replicated
==============================  =======================  ====================

A dim is sharded only when the axis size divides it (``_fit``).
:func:`param_spec` maps a port parameter (torch name and layout: a Linear
weight is [out, in], a conv weight [O, I, kh, kw]) to its Flax path and
returns the spec in the torch layout; :func:`param_partition_specs` does so
for a whole model.

:func:`shard_params` applies the table:

* ``tensor``: a ``parallelize_module`` plan a block: q/k/v, gate/up, fc1
  and the projector's ``linear_1`` column-wise, o, down, fc2 and
  ``linear_2`` row-wise, where the table shards them.  An attention is
  split only when its query and kv head counts both divide the tensor size
  (each rank then runs whole heads, the local GQA group integral: the
  0.5B student's 14 / 2 heads at tensor = 4 stay replicated, where GSPMD
  would split the projection columns and reshard); an MLP only when its
  intermediate width divides.
* ``fsdp`` / ``data``: FSDP2 ``fully_shard`` of every decoder and encoder
  layer and then of the root, over the fsdp dim (HSDP, replicated over
  ``data``, when data > 1).  FSDP2 shards each parameter's dim 0 (of its
  tensor-parallel shard), not the table's fsdp dim: the table's fsdp dim
  is a choice of the Flax layout, and FSDP2 gathers whole parameters
  before use either way.

Where torch does not follow the table, the parameter is replicated over
``tensor`` (and still sharded by FSDP):

* ``embed_tokens`` and ``lm_head``: the fused losses take the head whole,
  in its [V, D] layout (the tied student head is the embedding), as the
  JAX ``ops/fused_spmd.py`` heads enter replicated; a table split over
  ``tensor`` would be gathered whole again every micro-batch.
* ``patch_embedding``: torch has no tensor-parallel style for a
  convolution.
* int8 models (``QLinear`` / ``QEmbedding``: the quantized teacher, int8
  serving, the evaluator's ``--quant`` under a mesh) are left replicated on
  every rank, though the table shards ``kernel_q`` like ``kernel``:
  (1) their int8, float32 and bf16 leaves in one layer are not one dtype,
  which FSDP2 needs, and torch's parallel styles take ``nn.Linear`` and
  ``nn.Embedding`` only; (2) a row-wise w8a8 split changes each row's
  activation absmax (the quantize pass's scale) unless that max is
  all-reduced first, and since K12 fuses the quantize pass and the scale
  epilogue, such a split would also need K12 to emit int32 partial sums,
  which it does not: tokens equal to one device would no longer follow by
  construction; (3) one card cannot measure the memory that sharding
  would save.  A ``QLinear`` tensor plan is a multi-card item (ROADMAP).

The batch: :func:`shard_batch` gives each rank its rows of the global batch
over (data, fsdp), the same rows to every rank of a tensor group.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .mesh import AXIS_DATA, AXIS_FSDP, AXIS_NAMES, AXIS_TENSOR, axis_size, dp_rank, dp_size


def _rule_for_path(path: Tuple[str, ...]) -> Tuple:
    """Logical spec for a param path (tuple of str keys, leaf name last)."""
    name = path[-1]
    parent = path[-2] if len(path) >= 2 else ""

    # --- norms / small vectors: replicated ---
    if name in ("scale", "weight") and (
        "layernorm" in parent or "layer_norm" in parent or parent in ("norm", "post_layernorm")
    ):
        return ()
    if name == "embedding":
        # V over fsdp, D over tensor (see the JAX module for why not the
        # other way round).
        return (AXIS_FSDP, AXIS_TENSOR)
    if name == "image_newline" or name == "position_embedding":
        return ()

    if name == "kernel":
        if parent in ("q_proj", "k_proj", "v_proj"):
            return (AXIS_FSDP, AXIS_TENSOR)
        if parent in ("o_proj", "out_proj"):
            return (AXIS_TENSOR, AXIS_FSDP)
        if parent in ("gate_proj", "up_proj", "fc1", "linear_1"):
            return (AXIS_FSDP, AXIS_TENSOR)
        if parent in ("down_proj", "fc2", "linear_2"):
            return (AXIS_TENSOR, AXIS_FSDP)
        if parent == "lm_head":
            return (AXIS_FSDP, AXIS_TENSOR)
        if parent == "patch_embedding":
            return (None, None, None, AXIS_TENSOR)
        return ()

    if name == "bias":
        if parent in ("q_proj", "k_proj", "v_proj", "fc1", "linear_1"):
            return (AXIS_TENSOR,)
        return ()

    # int8 frozen-teacher weights: kernel_q shards exactly like kernel;
    # kernel_scale [out] follows the kernel's output dim.
    if name == "kernel_q":
        if parent in ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj", "fc1"):
            return (AXIS_FSDP, AXIS_TENSOR)
        if parent in ("o_proj", "down_proj", "out_proj", "fc2"):
            return (AXIS_TENSOR, AXIS_FSDP)
        if parent == "lm_head":
            # stored vocab-major [Vt, Dt]: the vocab axis shards over tensor
            return (AXIS_TENSOR, AXIS_FSDP)
        return ()
    if name == "kernel_scale":
        if parent in ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj", "fc1"):
            return (AXIS_TENSOR,)
        if parent in ("o_proj", "down_proj", "out_proj", "fc2"):
            return (AXIS_FSDP,)
        if parent == "lm_head":
            return (AXIS_TENSOR,)
        return ()
    # int8 token embedding: as "embedding"; the per-row scale follows V.
    if name == "embedding_q":
        return (AXIS_FSDP, AXIS_TENSOR)
    if name == "embedding_scale":
        return (AXIS_FSDP, None)

    return ()


def _fit(spec: Tuple, shape: Tuple[int, ...], sizes: Dict[str, int]) -> Tuple:
    """Pad the spec to the leaf rank; drop axes whose size doesn't divide."""
    out = []
    for d in range(len(shape)):
        ax = spec[d] if d < len(spec) else None
        if ax is not None and shape[d] % sizes[ax] != 0:
            ax = None
        out.append(ax)
    return tuple(out)


# 1-D ``weight``s of LayerNorms (Flax ``scale``); RMSNorm keeps ``weight``.
_LAYER_NORMS = ("layer_norm1", "layer_norm2", "post_layernorm")


def flax_leaf(name: str, ndim: int) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """A port parameter name -> (its Flax path, ``perm``): Flax dim j is the
    torch dim ``perm[j]`` (``models/convert.py``'s layout rules)."""
    parts = re.sub(r"\blayers\.(\d+)\b", r"layers_\1", name).split(".")
    module, leaf = parts[:-1], parts[-1]
    embed = module[-1:] == ["embed_tokens"]
    ident = tuple(range(ndim))
    if leaf == "weight_q":
        if embed:
            return tuple(module) + ("embedding_q",), ident
        return tuple(module) + ("kernel_q",), ident if module[-1] == "lm_head" else (1, 0)
    if leaf == "weight_scale":
        return tuple(module) + ("embedding_scale" if embed else "kernel_scale",), ident
    if leaf == "weight":
        if ndim == 2 and embed:
            return tuple(module) + ("embedding",), ident
        if ndim == 2:
            return tuple(module) + ("kernel",), (1, 0)
        if ndim == 4:
            return tuple(module) + ("kernel",), (2, 3, 1, 0)
        if module[-1] in _LAYER_NORMS:
            return tuple(module) + ("scale",), ident
    return tuple(module) + (leaf,), ident


def _sizes(mesh) -> Dict[str, int]:
    if isinstance(mesh, dict):
        return {a: mesh.get(a, 1) for a in AXIS_NAMES}
    return {a: axis_size(mesh, a) for a in AXIS_NAMES}


def param_spec(name: str, shape, mesh) -> Tuple:
    """The table's spec of one port parameter, in its torch layout.
    ``mesh`` is a DeviceMesh or a {axis: size} dict."""
    path, perm = flax_leaf(name, len(shape))
    flax_shape = tuple(shape[p] for p in perm)
    spec = _fit(_rule_for_path(path), flax_shape, _sizes(mesh))
    out = [None] * len(shape)
    for j, p in enumerate(perm):
        out[p] = spec[j]
    return tuple(out)


def param_partition_specs(model: nn.Module, mesh) -> Dict[str, Tuple]:
    """{parameter name: spec in the torch layout} for every parameter of
    ``model`` (a model on the meta device will do)."""
    return {n: param_spec(n, tuple(p.shape), mesh) for n, p in model.named_parameters()}


def logical_to_sharding(specs: Dict[str, Tuple], mesh) -> Dict[str, list]:
    """Specs -> DTensor placements, one a mesh dim (data, fsdp, tensor):
    ``Shard(d)`` where the spec puts that axis on dim d, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = {}
    for name, spec in specs.items():
        pl = [Replicate() for _ in AXIS_NAMES]
        for d, ax in enumerate(spec):
            if ax is not None:
                pl[AXIS_NAMES.index(ax)] = Shard(d)
        out[name] = pl
    return out


def _split_over_tensor(model: nn.Module, prefix: str, names, dim: int, t: int) -> bool:
    """Whether the table splits every listed Linear's weight over tensor on
    torch dim ``dim`` (0: columns of the output, 1: rows of the input)."""
    mods = dict(model.named_modules())
    for n in names:
        m = mods.get(f"{prefix}.{n}")
        if not isinstance(m, nn.Linear):
            return False
        w = f"{prefix}.{n}.weight"
        if param_spec(w, tuple(m.weight.shape), {AXIS_TENSOR: t})[dim] != AXIS_TENSOR:
            return False
    return True


def tensor_plan(model: nn.Module, t: int) -> Dict[str, str]:
    """{Linear's name: "colwise" | "rowwise"}: the tensor-parallel plan of
    ``model`` at tensor size ``t`` (see the module docstring)."""
    plan: Dict[str, str] = {}
    if t == 1:
        return plan

    def pair(prefix, cols, rows, heads=()):
        if any(h % t for h in heads):
            return
        if _split_over_tensor(model, prefix, cols, 0, t) and _split_over_tensor(model, prefix, rows, 1, t):
            plan.update({f"{prefix}.{c}": "colwise" for c in cols})
            plan.update({f"{prefix}.{r}": "rowwise" for r in rows})

    cfg = model.cfg
    for i in range(len(model.vision_tower.layers)):
        p = f"vision_tower.layers.{i}"
        pair(f"{p}.self_attn", ("q_proj", "k_proj", "v_proj"), ("out_proj",), (cfg.vision.num_attention_heads,))
        pair(f"{p}.mlp", ("fc1",), ("fc2",))
    pair("multi_modal_projector", ("linear_1",), ("linear_2",))
    tc = cfg.text
    for i in range(len(model.language_model.layers)):
        p = f"language_model.layers.{i}"
        pair(f"{p}.self_attn", ("q_proj", "k_proj", "v_proj"), ("o_proj",),
             (tc.num_attention_heads, tc.num_key_value_heads))
        pair(f"{p}.mlp", ("gate_proj", "up_proj"), ("down_proj",))
    return plan


def local_out_features(linear: nn.Module) -> int:
    """The output features of ``linear`` (an ``nn.Linear`` or a
    ``QLinear``) that this rank's forward computes: out / t for a weight
    split column-wise over ``tensor``, else all of them.  FSDP's split of
    dim 0 does not count: FSDP gathers the weight before the forward."""
    from torch.distributed.tensor import DTensor

    w = linear.weight_q if hasattr(linear, "weight_q") else linear.weight
    n = w.shape[0]
    if isinstance(w, DTensor):
        mesh = w.device_mesh
        for i, (name, pl) in enumerate(zip(mesh.mesh_dim_names or (), w.placements)):
            if name == AXIS_TENSOR and pl.is_shard(0):
                n //= mesh.size(i)
    return n


def is_quantized(model: nn.Module) -> bool:
    from ..models.qwen2 import QEmbedding, QLinear

    return any(isinstance(m, (QLinear, QEmbedding)) for m in model.modules())


def _dp_mesh(mesh):
    return mesh[AXIS_DATA, AXIS_FSDP] if axis_size(mesh, AXIS_DATA) > 1 else mesh[AXIS_FSDP]


def shard_params(model: nn.Module, mesh, *, param_dtype: Optional[torch.dtype] = None) -> nn.Module:
    """Shard ``model`` in place over ``mesh`` by the table (see the module
    docstring) and return it.  ``param_dtype``: the dtype the layers compute
    in (FSDP2's ``MixedPrecisionPolicy``, gradients reduced in float32),
    for a trained model whose sharded parameters are its float32 masters;
    None computes in the parameters' own dtype.  ``requires_grad`` is kept
    as it was (the tensor-parallel styles make new parameters)."""
    if is_quantized(model):
        return model
    from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard
    from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel, parallelize_module

    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    t = axis_size(mesh, AXIS_TENSOR)
    plan = tensor_plan(model, t)
    if plan:
        styles = {"colwise": ColwiseParallel, "rowwise": RowwiseParallel}
        parallelize_module(model, mesh[AXIS_TENSOR], {n: styles[s]() for n, s in plan.items()})
    for n, p in model.named_parameters():
        p.requires_grad_(n not in frozen)
    kw = dict(mesh=_dp_mesh(mesh))
    if param_dtype is not None:
        kw["mp_policy"] = MixedPrecisionPolicy(param_dtype=param_dtype, reduce_dtype=torch.float32)
    for layer in list(model.vision_tower.layers) + list(model.language_model.layers):
        fully_shard(layer, **kw)
    fully_shard(model, **kw)
    return model


def batch_sharding(mesh, accum: bool = False) -> Tuple[int, int, int]:
    """(batch axis, shards, this rank's shard): the batch axis (1 with a
    leading accumulation axis, else 0) splits over (data, fsdp)."""
    return (1 if accum else 0), dp_size(mesh), dp_rank(mesh)


def shard_batch(batch: Dict[str, Any], mesh, accum: bool = True) -> Dict[str, Any]:
    """This rank's rows of a host batch (numpy or tensors): the batch axis
    split evenly over (data, fsdp), whole over tensor.  Raises ValueError
    when the shards do not divide the batch (as the JAX ``device_put``
    refuses it)."""
    axis, n, r = batch_sharding(mesh, accum)
    out = {}
    for k, v in batch.items():
        b = v.shape[axis]
        if b % n:
            raise ValueError(f"batch {k!r} has {b} rows on axis {axis}, not a multiple of "
                             f"data x fsdp = {n}")
        idx = [slice(None)] * v.ndim
        idx[axis] = slice(r * (b // n), (r + 1) * (b // n))
        part = v[tuple(idx)]
        out[k] = np.ascontiguousarray(part) if isinstance(v, np.ndarray) else part.contiguous()
    return out
