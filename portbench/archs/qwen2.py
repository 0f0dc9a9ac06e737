"""Qwen2 (HF ``Qwen2Model``, ``model_type`` "qwen2"), the language model of
LLaVA-OneVision's 0.5B student and 7B teacher: GQA attention with q, k and
v biases, RoPE, a SwiGLU MLP, RMSNorm, a head tied to the embedding or its
own.  The port runs its attention on the flash kernels K3 (forward) and K4
(the student's backward)."""

from __future__ import annotations

from typing import List, Tuple

from portbench import weights
from portbench.counts import kernels

GROUPS: tuple = ()


def head_dim(tc: dict) -> int:
    return tc.get("head_dim") or tc["hidden_size"] // tc["num_attention_heads"]


def port_text_config(port, tc: dict):
    return port("configs").Qwen2Config(
        vocab_size=tc["vocab_size"], hidden_size=tc["hidden_size"], intermediate_size=tc["intermediate_size"],
        num_hidden_layers=tc["num_hidden_layers"], num_attention_heads=tc["num_attention_heads"],
        num_key_value_heads=tc["num_key_value_heads"], head_dim=head_dim(tc),
        rms_norm_eps=tc["rms_norm_eps"], rope_theta=tc["rope_theta"],
        tie_word_embeddings=tc["tie_word_embeddings"])


def leaves(tc: dict) -> List[weights.Leaf]:
    dt = tc["hidden_size"]
    out: List[weights.Leaf] = [("language_model.embed_tokens.weight", (tc["vocab_size"], dt), "normal", 0.02)]
    hd, hq, hkv = head_dim(tc), tc["num_attention_heads"], tc["num_key_value_heads"]
    for i in range(tc["num_hidden_layers"]):
        lm = f"language_model.layers.{i}"
        out += weights.norm(f"{lm}.input_layernorm", dt, False)
        out += weights.linear(f"{lm}.self_attn.q_proj", hq * hd, dt, True)
        out += weights.linear(f"{lm}.self_attn.k_proj", hkv * hd, dt, True)
        out += weights.linear(f"{lm}.self_attn.v_proj", hkv * hd, dt, True)
        out += weights.linear(f"{lm}.self_attn.o_proj", dt, hq * hd, False)
        out += weights.norm(f"{lm}.post_attention_layernorm", dt, False)
        out += weights.linear(f"{lm}.mlp.gate_proj", tc["intermediate_size"], dt, False)
        out += weights.linear(f"{lm}.mlp.up_proj", tc["intermediate_size"], dt, False)
        out += weights.linear(f"{lm}.mlp.down_proj", dt, tc["intermediate_size"], False)
    out += weights.norm("language_model.norm", dt, False)
    if not tc["tie_word_embeddings"]:
        out += weights.linear("language_model.lm_head", tc["vocab_size"], dt, False)
    return out


def lm_flops(tc: dict, rows: int, valid: int) -> Tuple[float, float]:
    d, i, hd = tc["hidden_size"], tc["intermediate_size"], head_dim(tc)
    hq, hkv, layers = tc["num_attention_heads"], tc["num_key_value_heads"], tc["num_hidden_layers"]
    per_token = 2.0 * d * (hq * hd + 2 * hkv * hd) + 2.0 * hq * hd * d + 3 * 2.0 * d * i
    pairs = kernels.attended_pairs(rows, [valid], causal=True)
    return layers * rows * per_token, layers * 4.0 * pairs * hq * hd


def lm_launches(tc: dict, lm, lse: bool) -> List[Tuple[str, float, float, int]]:
    """The student's K3 d64 and K4 (``lse``), or the teacher's K3 d128."""
    hq, hkv, hd, ll = tc["num_attention_heads"], tc["num_key_value_heads"], head_dim(tc), tc["num_hidden_layers"]
    if not lse:
        return [("K3 d128", *kernels.flash_fwd(lm, hq, hkv, hd, causal=True, masked=True, lse=False), ll)]
    k3 = kernels.flash_fwd(lm, hq, hkv, hd, causal=True, masked=True, lse=True)
    k4 = kernels.flash_bwd(lm, hq, hkv, hd, causal=True, masked=True)
    return [("K3 d64", *k3, ll), ("K4", *k4, ll)]


def counters(port) -> dict:
    return {}
