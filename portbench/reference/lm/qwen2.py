"""Qwen2 (HF ``Qwen2Model``, ``model_type`` "qwen2") in plain float32: GQA
attention with q, k and v biases and RoPE, a SwiGLU MLP, RMSNorm."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.layers import Weights, attention, checkpointed, linear, rms_norm


def _rope(s: int, hd: int, theta: float, device):
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, device=device, dtype=torch.float32) / hd)
    f = torch.arange(s, device=device, dtype=torch.float32)[:, None] * inv[None]
    emb = torch.cat([f, f], dim=-1)
    return emb.cos(), emb.sin()


def _rotate(x, cos, sin):
    h = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., h:], x[..., :h]], dim=-1) * sin


def forward(W: Weights, tc: dict, x: torch.Tensor, valid: torch.Tensor, precision: str, ckpt: bool):
    """x [B, S, D] input embeddings, valid [B, S] the real tokens (right
    padded) -> the final-norm hidden states [B, S, D].  Causal attention
    over the valid keys."""
    b, s, d = x.shape
    hd = tc.get("head_dim") or d // tc["num_attention_heads"]
    hq, hkv, eps = tc["num_attention_heads"], tc["num_key_value_heads"], tc["rms_norm_eps"]
    cos, sin = _rope(s, hd, tc["rope_theta"], x.device)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    allowed = [causal & valid[j][None, :] for j in range(b)]

    def layer(x, i):
        pre = f"language_model.layers.{i}"
        h = rms_norm(x, W(f"{pre}.input_layernorm.weight"), eps)

        def proj(name, heads):
            y = linear(h, W(f"{pre}.self_attn.{name}.weight"), W(f"{pre}.self_attn.{name}.bias"), precision)
            return y.view(b, s, heads, hd).transpose(1, 2)

        q, k, v = proj("q_proj", hq), proj("k_proj", hkv), proj("v_proj", hkv)
        q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
        att = torch.stack([attention(q[j], k[j], v[j], allowed[j]) for j in range(b)])
        x = x + linear(att.transpose(1, 2).reshape(b, s, hq * hd), W(f"{pre}.self_attn.o_proj.weight"),
                       None, precision)
        h = rms_norm(x, W(f"{pre}.post_attention_layernorm.weight"), eps)
        gate = linear(h, W(f"{pre}.mlp.gate_proj.weight"), None, precision)
        up = linear(h, W(f"{pre}.mlp.up_proj.weight"), None, precision)
        return x + linear(F.silu(gate) * up, W(f"{pre}.mlp.down_proj.weight"), None, precision)

    for i in range(tc["num_hidden_layers"]):
        x = checkpointed(layer, x, i, ckpt=ckpt)
    return rms_norm(x, W("language_model.norm.weight"), eps)


