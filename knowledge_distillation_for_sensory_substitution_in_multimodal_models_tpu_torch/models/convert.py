"""Weights: the HF safetensors reader and key mapping, and the bridge to and
from the JAX package's Flax param tree.

:func:`convert_hf_state_dict` remaps an HF LLaVA-OneVision state dict
(``model.language_model.layers...`` or the legacy
``language_model.model.layers...`` scheme) into the Flax-layout param tree
of numpy arrays that the JAX package's ``models/convert.py`` emits:

* torch ``nn.Linear`` weight [out, in] -> Dense ``kernel`` [in, out];
* torch ``nn.Conv2d`` weight [O, I, kh, kw] -> Conv ``kernel`` [kh, kw, I, O];
* embeddings and norms copy through.

:func:`params_from_flax` turns such a tree into this package's
``state_dict``:

* Dense ``kernel`` [in, out] -> ``weight`` [out, in];
* Conv ``kernel`` [kh, kw, in, out] (HWIO) -> ``weight`` OIHW;
* LayerNorm ``scale`` -> ``weight``; ``Embed.embedding`` -> ``weight`` (the
  tied head reads it);
* ``layers_{i}`` scopes -> ``layers.{i}``; everything else (biases, RMSNorm
  weights, ``position_embedding``, ``image_newline``) copies through;
* the int8 leaves of ``quantize_lm_params_int8``: QDense ``kernel_q``
  [in, out] -> ``weight_q`` [out, in] (int8), except the head's, which the
  JAX package already stores vocab-major [Vt, Dt] and which copies as it
  is; ``kernel_scale`` -> ``weight_scale``; QEmbed ``embedding_q`` /
  ``embedding_scale`` -> ``weight_q`` / ``weight_scale``.

:func:`flax_from_state_dict` is its inverse: a ``state_dict`` (or its
gradients, by the same names) back into the Flax tree layout, as numpy
arrays, so the tests can hold the port's gradients and updated weights
against the JAX package's leaf by leaf.

:func:`load_llava_onevision_params` chains the safetensors reader, the HF
key mapping and :func:`params_from_flax`.

:func:`panesar_params_from_flax` does for the JAX ``PanesarVQAModel`` tree
what :func:`params_from_flax` does for LLaVA-OneVision (``models/panesar.py``).
"""

from __future__ import annotations

import os
import re
from typing import Dict, Mapping

import numpy as np
import torch

from ..configs import LlavaOnevisionConfig


def _np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    return t.detach().to("cpu").float().numpy()


def _normalize_key(k: str) -> str:
    """Map every known HF key scheme to the canonical new-style scheme."""
    k = re.sub(r"^model\.", "", k)
    k = k.replace("language_model.model.", "language_model.")
    # legacy serialization nests the head under the LM wrapper
    k = k.replace("language_model.lm_head.", "lm_head.")
    return k


def convert_hf_state_dict(state_dict: Mapping[str, np.ndarray], cfg: LlavaOnevisionConfig) -> Dict:
    """HF state dict (numpy arrays or tensors) -> the Flax-layout param tree
    of ``LlavaOnevision``; raises on any key left unconverted."""
    sd = {_normalize_key(k): v for k, v in state_dict.items()}

    def take(key: str) -> np.ndarray:
        return _np(sd.pop(key))

    def linear(prefix: str, bias: bool = True) -> Dict:
        out = {"kernel": take(prefix + ".weight").T}
        if bias and prefix + ".bias" in sd:
            out["bias"] = take(prefix + ".bias")
        return out

    def layernorm(prefix: str) -> Dict:
        return {"scale": take(prefix + ".weight"), "bias": take(prefix + ".bias")}

    def rmsnorm(prefix: str) -> Dict:
        return {"weight": take(prefix + ".weight")}

    vt = "vision_tower.vision_model"
    conv_w = take(f"{vt}.embeddings.patch_embedding.weight")
    vision: Dict = {
        "patch_embedding": {"kernel": conv_w.transpose(2, 3, 1, 0),
                            "bias": take(f"{vt}.embeddings.patch_embedding.bias")},
        "position_embedding": take(f"{vt}.embeddings.position_embedding.weight"),
    }
    for i in range(cfg.vision.num_hidden_layers):
        lp = f"{vt}.encoder.layers.{i}"
        vision[f"layers_{i}"] = {
            "layer_norm1": layernorm(f"{lp}.layer_norm1"),
            "layer_norm2": layernorm(f"{lp}.layer_norm2"),
            "self_attn": {n: linear(f"{lp}.self_attn.{n}")
                          for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "mlp": {"fc1": linear(f"{lp}.mlp.fc1"), "fc2": linear(f"{lp}.mlp.fc2")},
        }
    vision["post_layernorm"] = layernorm(f"{vt}.post_layernorm")

    params: Dict = {
        "vision_tower": vision,
        "multi_modal_projector": {"linear_1": linear("multi_modal_projector.linear_1"),
                                  "linear_2": linear("multi_modal_projector.linear_2")},
        "image_newline": take("image_newline"),
    }
    lm: Dict = {"embed_tokens": {"embedding": take("language_model.embed_tokens.weight")}}
    for i in range(cfg.text.num_hidden_layers):
        lp = f"language_model.layers.{i}"
        lm[f"layers_{i}"] = {
            "input_layernorm": rmsnorm(f"{lp}.input_layernorm"),
            "post_attention_layernorm": rmsnorm(f"{lp}.post_attention_layernorm"),
            "self_attn": {
                "q_proj": linear(f"{lp}.self_attn.q_proj"),
                "k_proj": linear(f"{lp}.self_attn.k_proj"),
                "v_proj": linear(f"{lp}.self_attn.v_proj"),
                "o_proj": linear(f"{lp}.self_attn.o_proj", bias=False),
            },
            "mlp": {n: linear(f"{lp}.mlp.{n}", bias=False)
                    for n in ("gate_proj", "up_proj", "down_proj")},
        }
    lm["norm"] = rmsnorm("language_model.norm")
    if not cfg.text.tie_word_embeddings:
        lm["lm_head"] = linear("lm_head", bias=False)
    else:
        sd.pop("lm_head.weight", None)  # tied; HF may still serialize it
    params["language_model"] = lm

    leftover = [k for k in sd if not k.endswith("rotary_emb.inv_freq")]
    if leftover:
        raise ValueError(f"unconverted HF keys: {leftover[:8]}{'...' if len(leftover) > 8 else ''}")
    return params


def load_safetensors_dir(path: str) -> Dict[str, torch.Tensor]:
    """Read all *.safetensors shards in a local HF snapshot directory (as
    torch tensors: numpy has no bfloat16, the dtype HF ships)."""
    from safetensors import safe_open

    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    state = {}
    for f in files:
        with safe_open(os.path.join(path, f), framework="pt") as reader:
            for k in reader.keys():
                state[k] = reader.get_tensor(k)
    return state


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
    """Flax ``params`` tree of ``LlavaOnevision`` (bf16/f32, or int8 from
    ``quantize_lm_params_int8``) -> torch ``state_dict``."""
    sd = {}
    for key, arr in _flatten(tree).items():
        name = re.sub(r"\blayers_(\d+)\b", r"layers.\1", key)
        module, _, leaf = name.rpartition(".")
        if leaf in ("kernel_q", "embedding_q"):
            if leaf == "kernel_q" and not module.endswith("lm_head"):
                arr = arr.T
            sd[module + ".weight_q"] = torch.from_numpy(np.array(arr, dtype=np.int8, order="C"))
            continue
        if leaf in ("kernel_scale", "embedding_scale"):
            name = module + ".weight_scale"
        elif leaf == "kernel":
            name = module + ".weight"
            arr = arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1)
        elif leaf in ("scale", "embedding"):
            name = module + ".weight"
        sd[name] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
    n_lm = sum(re.match(r"language_model\.layers\.\d+\..*o_proj\.weight(_q)?$", k) is not None for k in sd)
    if n_lm != cfg.text.num_hidden_layers:
        raise ValueError(f"tree has {n_lm} LM layers, config {cfg.text.num_hidden_layers}")
    return sd


# 1-D ``weight``s of LayerNorms (Flax ``scale``); RMSNorm keeps ``weight``.
_LAYER_NORMS = ("layer_norm1", "layer_norm2", "post_layernorm")


def flax_from_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict:
    """Torch ``state_dict`` -> nested Flax ``params`` tree of numpy arrays
    (float32, and int8 for the quantized weights), the inverse of
    :func:`params_from_flax`."""
    tree: Dict = {}
    for name, t in sd.items():
        t = t.detach().cpu()
        arr = t.numpy() if t.dtype == torch.int8 else t.float().numpy()
        parts = re.sub(r"\blayers\.(\d+)\b", r"layers_\1", name).split(".")
        module, leaf = parts[:-1], parts[-1]
        embed = module[-1:] == ["embed_tokens"]
        if leaf == "weight_q":
            leaf = "embedding_q" if embed else "kernel_q"
            if not embed and module[-1] != "lm_head":
                arr = arr.T
        elif leaf == "weight_scale":
            leaf = "embedding_scale" if embed else "kernel_scale"
        elif leaf == "weight":
            if arr.ndim == 2 and embed:
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
    return params_from_flax(convert_hf_state_dict(load_safetensors_dir(path), cfg), cfg)


# Flax OptimizedLSTMCell's gates in torch's order (i, f, g, o): input
# kernels i* without bias, hidden-state kernels h* with bias.
_LSTM_GATES = ("i", "f", "g", "o")
_PANESAR_PERM = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}


def panesar_params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``params`` tree of the JAX ``PanesarVQAModel`` -> the port's
    ``models/panesar.py`` state dict (float32):

    * ``features.conv_{i}`` (HWIO) -> ``features.{torchvision position}``
      (OIHW); Dense kernels [in, out] -> weights [out, in];
    * ``OptimizedLSTMCell_{l}`` -> ``lstm_{l}``: ``weight_ih_l0`` the input
      kernels ``ii|if|ig|io`` stacked (transposed), ``weight_hh_l0`` the
      hidden-state kernels ``hi|hf|hg|ho``, ``bias_hh_l0`` their biases and
      ``bias_ih_l0`` zero (the cell has no input bias);
    * ``conv1d``: Flax ``Conv(1, (1,))`` kernel [1, 2, 1] (width, in, out)
      -> ``Conv1d(2, 1, 1)`` weight [1, 2, 1] (out, in, width);
    * ``Embed.embedding`` -> ``weight``."""
    from .panesar import vgg16_conv_positions

    positions = vgg16_conv_positions()
    flat = _flatten(tree)
    sd: Dict[str, torch.Tensor] = {}

    def put(name, arr):
        sd[name] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))

    cells = sorted({k.rsplit(".", 2)[0] for k in flat if ".OptimizedLSTMCell_" in k})
    for cell in cells:
        enc, _, layer = cell.rpartition(".OptimizedLSTMCell_")
        lstm = f"{enc}.lstm_{layer}"
        put(f"{lstm}.weight_ih_l0", np.concatenate([flat[f"{cell}.i{g}.kernel"] for g in _LSTM_GATES], 1).T)
        put(f"{lstm}.weight_hh_l0", np.concatenate([flat[f"{cell}.h{g}.kernel"] for g in _LSTM_GATES], 1).T)
        bias = np.concatenate([flat[f"{cell}.h{g}.bias"] for g in _LSTM_GATES])
        put(f"{lstm}.bias_hh_l0", bias)
        put(f"{lstm}.bias_ih_l0", np.zeros_like(bias))
    for key, arr in flat.items():
        if ".OptimizedLSTMCell_" in key:
            continue
        module, _, leaf = key.rpartition(".")
        module = re.sub(r"\bfeatures\.conv_(\d+)$", lambda m: f"features.{positions[int(m.group(1))]}", module)
        if leaf == "kernel":  # Dense [in, out], Conv1d (W, I, O), Conv2d HWIO -> torch layouts
            arr, leaf = arr.transpose(_PANESAR_PERM[arr.ndim]), "weight"
        elif leaf == "embedding":
            leaf = "weight"
        put(f"{module}.{leaf}", arr)
    return sd
