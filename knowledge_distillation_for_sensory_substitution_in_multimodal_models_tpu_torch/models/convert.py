"""Weights carried across from the JAX package.

:func:`params_from_flax` turns the JAX package's Flax param tree (numpy
arrays) into this package's ``state_dict``:

* Dense ``kernel`` [in, out] -> ``weight`` [out, in];
* Conv ``kernel`` [kh, kw, in, out] (HWIO) -> ``weight`` OIHW;
* LayerNorm ``scale`` -> ``weight``; ``Embed.embedding`` -> ``weight`` (the
  tied head reads it);
* ``layers_{i}`` scopes -> ``layers.{i}``; everything else (biases, RMSNorm
  weights, ``position_embedding``, ``image_newline``) copies through.

:func:`flax_from_state_dict` is its inverse: a ``state_dict`` (or its
gradients, by the same names) back into the Flax tree layout, as numpy
arrays, so the tests can hold the port's gradients and updated weights
against the JAX package's leaf by leaf.

:func:`load_llava_onevision_params` chains the JAX package's HF -> numpy
converter (its ``models/convert.py``, which imports no jax) into it.
"""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path
from typing import Dict, Mapping

import numpy as np
import torch

import knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu as _ref
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.configs import (
    LlavaOnevisionConfig,
)


def _ref_convert_module():
    """The JAX package's ``models/convert.py``, loaded by file path: importing
    it through its package would run ``models/__init__.py``, which imports
    flax.  The module itself needs only numpy and the (jax-free) configs."""
    path = Path(_ref.__file__).parent / "models" / "convert.py"
    # The name's parent (the JAX package's `models`) resolves the module's
    # `from ..configs import`; the module is not registered in sys.modules.
    spec = importlib.util.spec_from_file_location(f"{_ref.__name__}.models._hf_convert", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def params_from_flax(tree: Mapping, cfg: LlavaOnevisionConfig) -> Dict[str, torch.Tensor]:
    """Flax ``params`` tree of ``LlavaOnevision`` -> torch ``state_dict``."""
    sd = {}
    for key, arr in _flatten(tree).items():
        name = re.sub(r"\blayers_(\d+)\b", r"layers.\1", key)
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "kernel":
            name = name[: -len("kernel")] + "weight"
            arr = arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1)
        elif leaf in ("scale", "embedding"):
            name = name[: -len(leaf)] + "weight"
        sd[name] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
    n_lm = sum(k.startswith("language_model.layers.") and k.endswith("o_proj.weight") for k in sd)
    if n_lm != cfg.text.num_hidden_layers:
        raise ValueError(f"tree has {n_lm} LM layers, config {cfg.text.num_hidden_layers}")
    return sd


# 1-D ``weight``s of LayerNorms (Flax ``scale``); RMSNorm keeps ``weight``.
_LAYER_NORMS = ("layer_norm1", "layer_norm2", "post_layernorm")


def flax_from_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict:
    """Torch ``state_dict`` -> nested Flax ``params`` tree of numpy arrays
    (float32), the inverse of :func:`params_from_flax`."""
    tree: Dict = {}
    for name, t in sd.items():
        arr = t.detach().float().cpu().numpy()
        parts = re.sub(r"\blayers\.(\d+)\b", r"layers_\1", name).split(".")
        module, leaf = parts[:-1], parts[-1]
        if leaf == "weight":
            if arr.ndim == 2 and module[-1] == "embed_tokens":
                leaf = "embedding"
            elif arr.ndim == 2:
                leaf, arr = "kernel", arr.T
            elif arr.ndim == 4:
                leaf, arr = "kernel", arr.transpose(2, 3, 1, 0)
            elif module[-1] in _LAYER_NORMS:
                leaf = "scale"
        node = tree
        for p in module:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree


def load_llava_onevision_params(path: str, cfg: LlavaOnevisionConfig) -> Dict[str, torch.Tensor]:
    """Local HF snapshot dir -> torch ``state_dict`` (no network)."""
    return params_from_flax(_ref_convert_module().load_llava_onevision_params(path, cfg), cfg)
